# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/cluster/v1/node_schema_status.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.schema.v1 import barrier_pb2 as banyandb_dot_schema_dot_v1_dot_barrier__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n,banyandb/cluster/v1/node_schema_status.proto\x12\x13\x62\x61nyandb.cluster.v1\x1a banyandb/schema/v1/barrier.proto\"\x17\n\x15GetMaxRevisionRequest\"2\n\x16GetMaxRevisionResponse\x12\x18\n\x10max_mod_revision\x18\x01 \x01(\x03\"E\n\x16GetKeyRevisionsRequest\x12+\n\x04keys\x18\x01 \x03(\x0b\x32\x1d.banyandb.schema.v1.SchemaKey\"`\n\x0bKeyRevision\x12*\n\x03key\x18\x01 \x01(\x0b\x32\x1d.banyandb.schema.v1.SchemaKey\x12\x14\n\x0cmod_revision\x18\x02 \x01(\x03\x12\x0f\n\x07present\x18\x03 \x01(\x08\"N\n\x17GetKeyRevisionsResponse\x12\x33\n\trevisions\x18\x01 \x03(\x0b\x32 .banyandb.cluster.v1.KeyRevision\"C\n\x14GetAbsentKeysRequest\x12+\n\x04keys\x18\x01 \x03(\x0b\x32\x1d.banyandb.schema.v1.SchemaKey\"\x86\x01\n\x15GetAbsentKeysResponse\x12\x32\n\x0b\x61\x62sent_keys\x18\x01 \x03(\x0b\x32\x1d.banyandb.schema.v1.SchemaKey\x12\x39\n\x12still_present_keys\x18\x02 \x03(\x0b\x32\x1d.banyandb.schema.v1.SchemaKey2\xda\x02\n\x17NodeSchemaStatusService\x12i\n\x0eGetMaxRevision\x12*.banyandb.cluster.v1.GetMaxRevisionRequest\x1a+.banyandb.cluster.v1.GetMaxRevisionResponse\x12l\n\x0fGetKeyRevisions\x12+.banyandb.cluster.v1.GetKeyRevisionsRequest\x1a,.banyandb.cluster.v1.GetKeyRevisionsResponse\x12\x66\n\rGetAbsentKeys\x12).banyandb.cluster.v1.GetAbsentKeysRequest\x1a*.banyandb.cluster.v1.GetAbsentKeysResponseBEZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/cluster/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.cluster.v1.node_schema_status_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'ZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/cluster/v1'
  _GETMAXREVISIONREQUEST._serialized_start=103
  _GETMAXREVISIONREQUEST._serialized_end=126
  _GETMAXREVISIONRESPONSE._serialized_start=128
  _GETMAXREVISIONRESPONSE._serialized_end=178
  _GETKEYREVISIONSREQUEST._serialized_start=180
  _GETKEYREVISIONSREQUEST._serialized_end=249
  _KEYREVISION._serialized_start=251
  _KEYREVISION._serialized_end=347
  _GETKEYREVISIONSRESPONSE._serialized_start=349
  _GETKEYREVISIONSRESPONSE._serialized_end=427
  _GETABSENTKEYSREQUEST._serialized_start=429
  _GETABSENTKEYSREQUEST._serialized_end=496
  _GETABSENTKEYSRESPONSE._serialized_start=499
  _GETABSENTKEYSRESPONSE._serialized_end=633
  _NODESCHEMASTATUSSERVICE._serialized_start=636
  _NODESCHEMASTATUSSERVICE._serialized_end=982
# @@protoc_insertion_point(module_scope)
