# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/schema/v1/barrier.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import duration_pb2 as google_dot_protobuf_dot_duration__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n banyandb/schema/v1/barrier.proto\x12\x12\x62\x61nyandb.schema.v1\x1a\x1egoogle/protobuf/duration.proto\"6\n\tSchemaKey\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\r\n\x05group\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\"_\n\x1b\x41waitRevisionAppliedRequest\x12\x14\n\x0cmin_revision\x18\x01 \x01(\x03\x12*\n\x07timeout\x18\x02 \x01(\x0b\x32\x19.google.protobuf.Duration\"\xb9\x01\n\x0bNodeLaggard\x12\x0c\n\x04node\x18\x01 \x01(\t\x12\x1c\n\x14\x63urrent_mod_revision\x18\x02 \x01(\x03\x12\x33\n\x0cmissing_keys\x18\x03 \x03(\x0b\x32\x1d.banyandb.schema.v1.SchemaKey\x12\x39\n\x12still_present_keys\x18\x04 \x03(\x0b\x32\x1d.banyandb.schema.v1.SchemaKey\x12\x0e\n\x06reason\x18\x05 \x01(\t\"b\n\x1c\x41waitRevisionAppliedResponse\x12\x0f\n\x07\x61pplied\x18\x01 \x01(\x08\x12\x31\n\x08laggards\x18\x02 \x03(\x0b\x32\x1f.banyandb.schema.v1.NodeLaggard\"\x8b\x01\n\x19\x41waitSchemaAppliedRequest\x12+\n\x04keys\x18\x01 \x03(\x0b\x32\x1d.banyandb.schema.v1.SchemaKey\x12\x15\n\rmin_revisions\x18\x02 \x03(\x03\x12*\n\x07timeout\x18\x03 \x01(\x0b\x32\x19.google.protobuf.Duration\"`\n\x1a\x41waitSchemaAppliedResponse\x12\x0f\n\x07\x61pplied\x18\x01 \x01(\x08\x12\x31\n\x08laggards\x18\x02 \x03(\x0b\x32\x1f.banyandb.schema.v1.NodeLaggard\"t\n\x19\x41waitSchemaDeletedRequest\x12+\n\x04keys\x18\x01 \x03(\x0b\x32\x1d.banyandb.schema.v1.SchemaKey\x12*\n\x07timeout\x18\x02 \x01(\x0b\x32\x19.google.protobuf.Duration\"`\n\x1a\x41waitSchemaDeletedResponse\x12\x0f\n\x07\x61pplied\x18\x01 \x01(\x08\x12\x31\n\x08laggards\x18\x02 \x03(\x0b\x32\x1f.banyandb.schema.v1.NodeLaggard2\xfb\x02\n\x14SchemaBarrierService\x12y\n\x14\x41waitRevisionApplied\x12/.banyandb.schema.v1.AwaitRevisionAppliedRequest\x1a\x30.banyandb.schema.v1.AwaitRevisionAppliedResponse\x12s\n\x12\x41waitSchemaApplied\x12-.banyandb.schema.v1.AwaitSchemaAppliedRequest\x1a..banyandb.schema.v1.AwaitSchemaAppliedResponse\x12s\n\x12\x41waitSchemaDeleted\x12-.banyandb.schema.v1.AwaitSchemaDeletedRequest\x1a..banyandb.schema.v1.AwaitSchemaDeletedResponseBn\n(org.apache.skywalking.banyandb.schema.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/schema/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.schema.v1.barrier_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n(org.apache.skywalking.banyandb.schema.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/schema/v1'
  _SCHEMAKEY._serialized_start=88
  _SCHEMAKEY._serialized_end=142
  _AWAITREVISIONAPPLIEDREQUEST._serialized_start=144
  _AWAITREVISIONAPPLIEDREQUEST._serialized_end=239
  _NODELAGGARD._serialized_start=242
  _NODELAGGARD._serialized_end=427
  _AWAITREVISIONAPPLIEDRESPONSE._serialized_start=429
  _AWAITREVISIONAPPLIEDRESPONSE._serialized_end=527
  _AWAITSCHEMAAPPLIEDREQUEST._serialized_start=530
  _AWAITSCHEMAAPPLIEDREQUEST._serialized_end=669
  _AWAITSCHEMAAPPLIEDRESPONSE._serialized_start=671
  _AWAITSCHEMAAPPLIEDRESPONSE._serialized_end=767
  _AWAITSCHEMADELETEDREQUEST._serialized_start=769
  _AWAITSCHEMADELETEDREQUEST._serialized_end=885
  _AWAITSCHEMADELETEDRESPONSE._serialized_start=887
  _AWAITSCHEMADELETEDRESPONSE._serialized_end=983
  _SCHEMABARRIERSERVICE._serialized_start=986
  _SCHEMABARRIERSERVICE._serialized_end=1365
# @@protoc_insertion_point(module_scope)
