"""Tenant identity (qos/tenancy), carried from banyandb_tpu.qos; the
admission plane comes with a later slice."""
