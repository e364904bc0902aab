# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/property/v1/property.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import common_pb2 as banyandb_dot_common_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import query_pb2 as banyandb_dot_model_dot_v1_dot_query__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n#banyandb/property/v1/property.proto\x12\x14\x62\x61nyandb.property.v1\x1a\x1f\x62\x61nyandb/common/v1/common.proto\x1a\x1d\x62\x61nyandb/model/v1/query.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"\x9c\x01\n\x08Property\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\n\n\x02id\x18\x02 \x01(\t\x12$\n\x04tags\x18\x03 \x03(\x0b\x32\x16.banyandb.model.v1.Tag\x12.\n\nupdated_at\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.TimestampBr\n*org.apache.skywalking.banyandb.property.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/property/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.property.v1.property_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n*org.apache.skywalking.banyandb.property.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/property/v1'
  _PROPERTY._serialized_start=159
  _PROPERTY._serialized_end=315
# @@protoc_insertion_point(module_scope)
