# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/bydbql/v1/rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.bydbql.v1 import query_pb2 as banyandb_dot_bydbql_dot_v1_dot_query__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1c\x62\x61nyandb/bydbql/v1/rpc.proto\x12\x12\x62\x61nyandb.bydbql.v1\x1a\x1e\x62\x61nyandb/bydbql/v1/query.proto2_\n\rBydbQLService\x12N\n\x05Query\x12 .banyandb.bydbql.v1.QueryRequest\x1a!.banyandb.bydbql.v1.QueryResponse\"\x00\x42n\n(org.apache.skywalking.banyandb.bydbql.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/bydbql/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.bydbql.v1.rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n(org.apache.skywalking.banyandb.bydbql.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/bydbql/v1'
  _BYDBQLSERVICE._serialized_start=84
  _BYDBQLSERVICE._serialized_end=179
# @@protoc_insertion_point(module_scope)
