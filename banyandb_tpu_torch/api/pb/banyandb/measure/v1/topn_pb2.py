# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/measure/v1/topn.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import trace_pb2 as banyandb_dot_common_dot_v1_dot_trace__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import common_pb2 as banyandb_dot_model_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import query_pb2 as banyandb_dot_model_dot_v1_dot_query__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1e\x62\x61nyandb/measure/v1/topn.proto\x12\x13\x62\x61nyandb.measure.v1\x1a\x1e\x62\x61nyandb/common/v1/trace.proto\x1a\x1e\x62\x61nyandb/model/v1/common.proto\x1a\x1d\x62\x61nyandb/model/v1/query.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"\x8b\x02\n\x08TopNList\x12-\n\ttimestamp\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x31\n\x05items\x18\x02 \x03(\x0b\x32\".banyandb.measure.v1.TopNList.Item\x1a\x9c\x01\n\x04Item\x12&\n\x06\x65ntity\x18\x01 \x03(\x0b\x32\x16.banyandb.model.v1.Tag\x12,\n\x05value\x18\x02 \x01(\x0b\x32\x1d.banyandb.model.v1.FieldValue\x12\x0f\n\x07version\x18\x03 \x01(\x03\x12-\n\ttimestamp\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"f\n\x0cTopNResponse\x12,\n\x05lists\x18\x01 \x03(\x0b\x32\x1d.banyandb.measure.v1.TopNList\x12(\n\x05trace\x18\x02 \x01(\x0b\x32\x19.banyandb.common.v1.Trace\"\xa5\x02\n\x0bTopNRequest\x12\x0e\n\x06groups\x18\x01 \x03(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x30\n\ntime_range\x18\x03 \x01(\x0b\x32\x1c.banyandb.model.v1.TimeRange\x12\r\n\x05top_n\x18\x04 \x01(\x05\x12\x33\n\x03\x61gg\x18\x05 \x01(\x0e\x32&.banyandb.model.v1.AggregationFunction\x12\x30\n\nconditions\x18\x06 \x03(\x0b\x32\x1c.banyandb.model.v1.Condition\x12\x31\n\x10\x66ield_value_sort\x18\x07 \x01(\x0e\x32\x17.banyandb.model.v1.Sort\x12\r\n\x05trace\x18\x08 \x01(\x08\x12\x0e\n\x06stages\x18\t \x03(\tBp\n)org.apache.skywalking.banyandb.measure.v1ZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/measure/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.measure.v1.topn_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n)org.apache.skywalking.banyandb.measure.v1ZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/measure/v1'
  _TOPNLIST._serialized_start=184
  _TOPNLIST._serialized_end=451
  _TOPNLIST_ITEM._serialized_start=295
  _TOPNLIST_ITEM._serialized_end=451
  _TOPNRESPONSE._serialized_start=453
  _TOPNRESPONSE._serialized_end=555
  _TOPNREQUEST._serialized_start=558
  _TOPNREQUEST._serialized_end=851
# @@protoc_insertion_point(module_scope)
