# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/property/v1/rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import common_pb2 as banyandb_dot_common_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.common.v1 import trace_pb2 as banyandb_dot_common_dot_v1_dot_trace__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import common_pb2 as banyandb_dot_model_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import query_pb2 as banyandb_dot_model_dot_v1_dot_query__pb2
from banyandb_tpu_torch.api.pb.banyandb.property.v1 import property_pb2 as banyandb_dot_property_dot_v1_dot_property__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1e\x62\x61nyandb/property/v1/rpc.proto\x12\x14\x62\x61nyandb.property.v1\x1a\x1f\x62\x61nyandb/common/v1/common.proto\x1a\x1e\x62\x61nyandb/common/v1/trace.proto\x1a\x1e\x62\x61nyandb/model/v1/common.proto\x1a\x1d\x62\x61nyandb/model/v1/query.proto\x1a#banyandb/property/v1/property.proto\"\xcf\x01\n\x0c\x41pplyRequest\x12\x30\n\x08property\x18\x01 \x01(\x0b\x32\x1e.banyandb.property.v1.Property\x12=\n\x08strategy\x18\x02 \x01(\x0e\x32+.banyandb.property.v1.ApplyRequest.Strategy\"N\n\x08Strategy\x12\x18\n\x14STRATEGY_UNSPECIFIED\x10\x00\x12\x12\n\x0eSTRATEGY_MERGE\x10\x01\x12\x14\n\x10STRATEGY_REPLACE\x10\x02\"2\n\rApplyResponse\x12\x0f\n\x07\x63reated\x18\x01 \x01(\x08\x12\x10\n\x08tags_num\x18\x02 \x01(\r\"8\n\rDeleteRequest\x12\r\n\x05group\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\n\n\x02id\x18\x03 \x01(\t\"!\n\x0e\x44\x65leteResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x08\"E\n\nQueryOrder\x12\x10\n\x08tag_name\x18\x01 \x01(\t\x12%\n\x04sort\x18\x0c \x01(\x0e\x32\x17.banyandb.model.v1.Sort\"\xd2\x01\n\x0cQueryRequest\x12\x0e\n\x06groups\x18\x01 \x03(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0b\n\x03ids\x18\x03 \x03(\t\x12-\n\x08\x63riteria\x18\x04 \x01(\x0b\x32\x1b.banyandb.model.v1.Criteria\x12\x16\n\x0etag_projection\x18\x05 \x03(\t\x12\r\n\x05limit\x18\x06 \x01(\r\x12\r\n\x05trace\x18\x07 \x01(\x08\x12\x32\n\x08order_by\x18\x08 \x01(\x0b\x32 .banyandb.property.v1.QueryOrder\"m\n\rQueryResponse\x12\x32\n\nproperties\x18\x01 \x03(\x0b\x32\x1e.banyandb.property.v1.Property\x12(\n\x05trace\x18\x02 \x01(\x0b\x32\x19.banyandb.common.v1.Trace\"g\n\x15InternalUpdateRequest\x12\n\n\x02id\x18\x01 \x01(\x0c\x12\x10\n\x08shard_id\x18\x02 \x01(\x04\x12\x30\n\x08property\x18\x03 \x01(\x0b\x32\x1e.banyandb.property.v1.Property\"$\n\x15InternalDeleteRequest\x12\x0b\n\x03ids\x18\x01 \x03(\x0c\"z\n\x15InternalQueryResponse\x12\x0f\n\x07sources\x18\x01 \x03(\x0c\x12(\n\x05trace\x18\x02 \x01(\x0b\x32\x19.banyandb.common.v1.Trace\x12\x0f\n\x07\x64\x65letes\x18\x03 \x03(\x03\x12\x15\n\rsorted_values\x18\x04 \x03(\x0c\"|\n\x15InternalRepairRequest\x12\x10\n\x08shard_id\x18\x01 \x01(\x04\x12\n\n\x02id\x18\x02 \x01(\x0c\x12\x30\n\x08property\x18\x03 \x01(\x0b\x32\x1e.banyandb.property.v1.Property\x12\x13\n\x0b\x64\x65lete_time\x18\x04 \x01(\x03\"\x18\n\x16InternalRepairResponse2\x90\x02\n\x0fPropertyService\x12R\n\x05\x41pply\x12\".banyandb.property.v1.ApplyRequest\x1a#.banyandb.property.v1.ApplyResponse\"\x00\x12U\n\x06\x44\x65lete\x12#.banyandb.property.v1.DeleteRequest\x1a$.banyandb.property.v1.DeleteResponse\"\x00\x12R\n\x05Query\x12\".banyandb.property.v1.QueryRequest\x1a#.banyandb.property.v1.QueryResponse\"\x00\x42r\n*org.apache.skywalking.banyandb.property.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/property/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.property.v1.rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n*org.apache.skywalking.banyandb.property.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/property/v1'
  _APPLYREQUEST._serialized_start=222
  _APPLYREQUEST._serialized_end=429
  _APPLYREQUEST_STRATEGY._serialized_start=351
  _APPLYREQUEST_STRATEGY._serialized_end=429
  _APPLYRESPONSE._serialized_start=431
  _APPLYRESPONSE._serialized_end=481
  _DELETEREQUEST._serialized_start=483
  _DELETEREQUEST._serialized_end=539
  _DELETERESPONSE._serialized_start=541
  _DELETERESPONSE._serialized_end=574
  _QUERYORDER._serialized_start=576
  _QUERYORDER._serialized_end=645
  _QUERYREQUEST._serialized_start=648
  _QUERYREQUEST._serialized_end=858
  _QUERYRESPONSE._serialized_start=860
  _QUERYRESPONSE._serialized_end=969
  _INTERNALUPDATEREQUEST._serialized_start=971
  _INTERNALUPDATEREQUEST._serialized_end=1074
  _INTERNALDELETEREQUEST._serialized_start=1076
  _INTERNALDELETEREQUEST._serialized_end=1112
  _INTERNALQUERYRESPONSE._serialized_start=1114
  _INTERNALQUERYRESPONSE._serialized_end=1236
  _INTERNALREPAIRREQUEST._serialized_start=1238
  _INTERNALREPAIRREQUEST._serialized_end=1362
  _INTERNALREPAIRRESPONSE._serialized_start=1364
  _INTERNALREPAIRRESPONSE._serialized_end=1388
  _PROPERTYSERVICE._serialized_start=1391
  _PROPERTYSERVICE._serialized_end=1663
# @@protoc_insertion_point(module_scope)
