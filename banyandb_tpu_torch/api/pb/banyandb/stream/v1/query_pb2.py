# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/stream/v1/query.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import trace_pb2 as banyandb_dot_common_dot_v1_dot_trace__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import query_pb2 as banyandb_dot_model_dot_v1_dot_query__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import write_pb2 as banyandb_dot_model_dot_v1_dot_write__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1e\x62\x61nyandb/stream/v1/query.proto\x12\x12\x62\x61nyandb.stream.v1\x1a\x1e\x62\x61nyandb/common/v1/trace.proto\x1a\x1d\x62\x61nyandb/model/v1/query.proto\x1a\x1d\x62\x61nyandb/model/v1/write.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"\x80\x01\n\x07\x45lement\x12\x12\n\nelement_id\x18\x01 \x01(\t\x12-\n\ttimestamp\x18\x02 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x32\n\x0ctag_families\x18\x03 \x03(\x0b\x32\x1c.banyandb.model.v1.TagFamily\"\x87\x02\n\rQueryResponse\x12-\n\x08\x65lements\x18\x01 \x03(\x0b\x32\x1b.banyandb.stream.v1.Element\x12(\n\x05trace\x18\x02 \x01(\x0b\x32\x19.banyandb.common.v1.Trace\x12L\n\x0egroup_statuses\x18\x32 \x03(\x0b\x32\x34.banyandb.stream.v1.QueryResponse.GroupStatusesEntry\x1aO\n\x12GroupStatusesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0e\x32\x19.banyandb.model.v1.Status:\x02\x38\x01\"\xc2\x03\n\x0cQueryRequest\x12\x0e\n\x06groups\x18\x01 \x03(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x30\n\ntime_range\x18\x03 \x01(\x0b\x32\x1c.banyandb.model.v1.TimeRange\x12\x0e\n\x06offset\x18\x04 \x01(\r\x12\r\n\x05limit\x18\x05 \x01(\r\x12/\n\x08order_by\x18\x06 \x01(\x0b\x32\x1d.banyandb.model.v1.QueryOrder\x12-\n\x08\x63riteria\x18\x07 \x01(\x0b\x32\x1b.banyandb.model.v1.Criteria\x12\x34\n\nprojection\x18\x08 \x01(\x0b\x32 .banyandb.model.v1.TagProjection\x12\r\n\x05trace\x18\t \x01(\x08\x12\x0e\n\x06stages\x18\n \x03(\t\x12T\n\x13group_mod_revisions\x18\x32 \x03(\x0b\x32\x37.banyandb.stream.v1.QueryRequest.GroupModRevisionsEntry\x1a\x38\n\x16GroupModRevisionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\x42n\n(org.apache.skywalking.banyandb.stream.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/stream/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.stream.v1.query_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n(org.apache.skywalking.banyandb.stream.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/stream/v1'
  _QUERYRESPONSE_GROUPSTATUSESENTRY._options = None
  _QUERYRESPONSE_GROUPSTATUSESENTRY._serialized_options = b'8\001'
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._options = None
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._serialized_options = b'8\001'
  _ELEMENT._serialized_start=182
  _ELEMENT._serialized_end=310
  _QUERYRESPONSE._serialized_start=313
  _QUERYRESPONSE._serialized_end=576
  _QUERYRESPONSE_GROUPSTATUSESENTRY._serialized_start=497
  _QUERYRESPONSE_GROUPSTATUSESENTRY._serialized_end=576
  _QUERYREQUEST._serialized_start=579
  _QUERYREQUEST._serialized_end=1029
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._serialized_start=973
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._serialized_end=1029
# @@protoc_insertion_point(module_scope)
