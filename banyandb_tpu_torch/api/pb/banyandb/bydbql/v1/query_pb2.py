# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/bydbql/v1/query.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.measure.v1 import query_pb2 as banyandb_dot_measure_dot_v1_dot_query__pb2
from banyandb_tpu_torch.api.pb.banyandb.measure.v1 import topn_pb2 as banyandb_dot_measure_dot_v1_dot_topn__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import common_pb2 as banyandb_dot_model_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.property.v1 import rpc_pb2 as banyandb_dot_property_dot_v1_dot_rpc__pb2
from banyandb_tpu_torch.api.pb.banyandb.stream.v1 import query_pb2 as banyandb_dot_stream_dot_v1_dot_query__pb2
from banyandb_tpu_torch.api.pb.banyandb.trace.v1 import query_pb2 as banyandb_dot_trace_dot_v1_dot_query__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1e\x62\x61nyandb/bydbql/v1/query.proto\x12\x12\x62\x61nyandb.bydbql.v1\x1a\x1f\x62\x61nyandb/measure/v1/query.proto\x1a\x1e\x62\x61nyandb/measure/v1/topn.proto\x1a\x1e\x62\x61nyandb/model/v1/common.proto\x1a\x1e\x62\x61nyandb/property/v1/rpc.proto\x1a\x1e\x62\x61nyandb/stream/v1/query.proto\x1a\x1d\x62\x61nyandb/trace/v1/query.proto\"J\n\x0cQueryRequest\x12\r\n\x05query\x18\x01 \x01(\t\x12+\n\x06params\x18\x02 \x03(\x0b\x32\x1b.banyandb.model.v1.TagValue\"\xc7\x02\n\rQueryResponse\x12:\n\rstream_result\x18\x01 \x01(\x0b\x32!.banyandb.stream.v1.QueryResponseH\x00\x12<\n\x0emeasure_result\x18\x02 \x01(\x0b\x32\".banyandb.measure.v1.QueryResponseH\x00\x12>\n\x0fproperty_result\x18\x03 \x01(\x0b\x32#.banyandb.property.v1.QueryResponseH\x00\x12\x38\n\x0ctrace_result\x18\x04 \x01(\x0b\x32 .banyandb.trace.v1.QueryResponseH\x00\x12\x38\n\x0btopn_result\x18\x05 \x01(\x0b\x32!.banyandb.measure.v1.TopNResponseH\x00\x42\x08\n\x06resultBn\n(org.apache.skywalking.banyandb.bydbql.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/bydbql/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.bydbql.v1.query_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n(org.apache.skywalking.banyandb.bydbql.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/bydbql/v1'
  _QUERYREQUEST._serialized_start=246
  _QUERYREQUEST._serialized_end=320
  _QUERYRESPONSE._serialized_start=323
  _QUERYRESPONSE._serialized_end=650
# @@protoc_insertion_point(module_scope)
