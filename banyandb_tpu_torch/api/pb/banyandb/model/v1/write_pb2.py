# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/model/v1/write.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1d\x62\x61nyandb/model/v1/write.proto\x12\x11\x62\x61nyandb.model.v1*\xb0\x02\n\x06Status\x12\x16\n\x12STATUS_UNSPECIFIED\x10\x00\x12\x12\n\x0eSTATUS_SUCCEED\x10\x01\x12\x1c\n\x18STATUS_INVALID_TIMESTAMP\x10\x02\x12\x14\n\x10STATUS_NOT_FOUND\x10\x03\x12\x19\n\x15STATUS_EXPIRED_SCHEMA\x10\x04\x12\x19\n\x15STATUS_INTERNAL_ERROR\x10\x05\x12\x14\n\x10STATUS_DISK_FULL\x10\x06\x12\x1e\n\x1aSTATUS_VERSION_UNSUPPORTED\x10\x07\x12\x1d\n\x19STATUS_VERSION_DEPRECATED\x10\x08\x12\x1c\n\x18STATUS_METADATA_REQUIRED\x10\t\x12\x1d\n\x19STATUS_SCHEMA_NOT_APPLIED\x10\nBl\n\'org.apache.skywalking.banyandb.model.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/model/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.model.v1.write_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n\'org.apache.skywalking.banyandb.model.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/model/v1'
  _STATUS._serialized_start=53
  _STATUS._serialized_end=357
# @@protoc_insertion_point(module_scope)
