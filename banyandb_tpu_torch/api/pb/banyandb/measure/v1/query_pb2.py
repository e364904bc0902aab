# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/measure/v1/query.proto
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
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import write_pb2 as banyandb_dot_model_dot_v1_dot_write__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1f\x62\x61nyandb/measure/v1/query.proto\x12\x13\x62\x61nyandb.measure.v1\x1a\x1e\x62\x61nyandb/common/v1/trace.proto\x1a\x1e\x62\x61nyandb/model/v1/common.proto\x1a\x1d\x62\x61nyandb/model/v1/query.proto\x1a\x1d\x62\x61nyandb/model/v1/write.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"\x87\x02\n\tDataPoint\x12-\n\ttimestamp\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x32\n\x0ctag_families\x18\x02 \x03(\x0b\x32\x1c.banyandb.model.v1.TagFamily\x12\x34\n\x06\x66ields\x18\x03 \x03(\x0b\x32$.banyandb.measure.v1.DataPoint.Field\x12\x0b\n\x03sid\x18\x04 \x01(\x04\x12\x0f\n\x07version\x18\x05 \x01(\x03\x1a\x43\n\x05\x46ield\x12\x0c\n\x04name\x18\x01 \x01(\t\x12,\n\x05value\x18\x02 \x01(\x0b\x32\x1d.banyandb.model.v1.FieldValue\"\x8e\x02\n\rQueryResponse\x12\x33\n\x0b\x64\x61ta_points\x18\x01 \x03(\x0b\x32\x1e.banyandb.measure.v1.DataPoint\x12(\n\x05trace\x18\x02 \x01(\x0b\x32\x19.banyandb.common.v1.Trace\x12M\n\x0egroup_statuses\x18\x32 \x03(\x0b\x32\x35.banyandb.measure.v1.QueryResponse.GroupStatusesEntry\x1aO\n\x12GroupStatusesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0e\x32\x19.banyandb.model.v1.Status:\x02\x38\x01\"Y\n\x11InternalDataPoint\x12\x32\n\ndata_point\x18\x01 \x01(\x0b\x32\x1e.banyandb.measure.v1.DataPoint\x12\x10\n\x08shard_id\x18\x02 \x01(\r\"f\n\x14InternalQueryRequest\x12\x32\n\x07request\x18\x01 \x01(\x0b\x32!.banyandb.measure.v1.QueryRequest\x12\x1a\n\x12\x61gg_return_partial\x18\x02 \x01(\x08\"\x96\x01\n\x15InternalQueryResponse\x12;\n\x0b\x64\x61ta_points\x18\x01 \x03(\x0b\x32&.banyandb.measure.v1.InternalDataPoint\x12(\n\x05trace\x18\x02 \x01(\x0b\x32\x19.banyandb.common.v1.Trace\x12\x16\n\x0eraw_frame_body\x18\x03 \x01(\x0c\"\x99\x08\n\x0cQueryRequest\x12\x0e\n\x06groups\x18\x01 \x03(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x30\n\ntime_range\x18\x03 \x01(\x0b\x32\x1c.banyandb.model.v1.TimeRange\x12-\n\x08\x63riteria\x18\x04 \x01(\x0b\x32\x1b.banyandb.model.v1.Criteria\x12\x38\n\x0etag_projection\x18\x05 \x01(\x0b\x32 .banyandb.model.v1.TagProjection\x12K\n\x10\x66ield_projection\x18\x06 \x01(\x0b\x32\x31.banyandb.measure.v1.QueryRequest.FieldProjection\x12;\n\x08group_by\x18\x07 \x01(\x0b\x32).banyandb.measure.v1.QueryRequest.GroupBy\x12:\n\x03\x61gg\x18\x08 \x01(\x0b\x32-.banyandb.measure.v1.QueryRequest.Aggregation\x12\x32\n\x03top\x18\t \x01(\x0b\x32%.banyandb.measure.v1.QueryRequest.Top\x12\x0e\n\x06offset\x18\n \x01(\r\x12\r\n\x05limit\x18\x0b \x01(\r\x12/\n\x08order_by\x18\x0c \x01(\x0b\x32\x1d.banyandb.model.v1.QueryOrder\x12\r\n\x05trace\x18\r \x01(\x08\x12\x0e\n\x06stages\x18\x0e \x03(\t\x12 \n\x18rewrite_agg_top_n_result\x18\x0f \x01(\x08\x12U\n\x13group_mod_revisions\x18\x32 \x03(\x0b\x32\x38.banyandb.measure.v1.QueryRequest.GroupModRevisionsEntry\x1a \n\x0f\x46ieldProjection\x12\r\n\x05names\x18\x01 \x03(\t\x1aW\n\x07GroupBy\x12\x38\n\x0etag_projection\x18\x01 \x01(\x0b\x32 .banyandb.model.v1.TagProjection\x12\x12\n\nfield_name\x18\x02 \x01(\t\x1a[\n\x0b\x41ggregation\x12\x38\n\x08\x66unction\x18\x01 \x01(\x0e\x32&.banyandb.model.v1.AggregationFunction\x12\x12\n\nfield_name\x18\x02 \x01(\t\x1a\\\n\x03Top\x12\x0e\n\x06number\x18\x01 \x01(\x05\x12\x12\n\nfield_name\x18\x02 \x01(\t\x12\x31\n\x10\x66ield_value_sort\x18\x03 \x01(\x0e\x32\x17.banyandb.model.v1.Sort\x1a\x38\n\x16GroupModRevisionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\x42p\n)org.apache.skywalking.banyandb.measure.v1ZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/measure/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.measure.v1.query_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n)org.apache.skywalking.banyandb.measure.v1ZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/measure/v1'
  _QUERYRESPONSE_GROUPSTATUSESENTRY._options = None
  _QUERYRESPONSE_GROUPSTATUSESENTRY._serialized_options = b'8\001'
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._options = None
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._serialized_options = b'8\001'
  _DATAPOINT._serialized_start=216
  _DATAPOINT._serialized_end=479
  _DATAPOINT_FIELD._serialized_start=412
  _DATAPOINT_FIELD._serialized_end=479
  _QUERYRESPONSE._serialized_start=482
  _QUERYRESPONSE._serialized_end=752
  _QUERYRESPONSE_GROUPSTATUSESENTRY._serialized_start=673
  _QUERYRESPONSE_GROUPSTATUSESENTRY._serialized_end=752
  _INTERNALDATAPOINT._serialized_start=754
  _INTERNALDATAPOINT._serialized_end=843
  _INTERNALQUERYREQUEST._serialized_start=845
  _INTERNALQUERYREQUEST._serialized_end=947
  _INTERNALQUERYRESPONSE._serialized_start=950
  _INTERNALQUERYRESPONSE._serialized_end=1100
  _QUERYREQUEST._serialized_start=1103
  _QUERYREQUEST._serialized_end=2152
  _QUERYREQUEST_FIELDPROJECTION._serialized_start=1786
  _QUERYREQUEST_FIELDPROJECTION._serialized_end=1818
  _QUERYREQUEST_GROUPBY._serialized_start=1820
  _QUERYREQUEST_GROUPBY._serialized_end=1907
  _QUERYREQUEST_AGGREGATION._serialized_start=1909
  _QUERYREQUEST_AGGREGATION._serialized_end=2000
  _QUERYREQUEST_TOP._serialized_start=2002
  _QUERYREQUEST_TOP._serialized_end=2094
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._serialized_start=2096
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._serialized_end=2152
# @@protoc_insertion_point(module_scope)
