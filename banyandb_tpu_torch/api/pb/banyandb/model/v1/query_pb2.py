# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/model/v1/query.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.model.v1 import common_pb2 as banyandb_dot_model_dot_v1_dot_common__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1d\x62\x61nyandb/model/v1/query.proto\x12\x11\x62\x61nyandb.model.v1\x1a\x1e\x62\x61nyandb/model/v1/common.proto\x1a\x1fgoogle/protobuf/timestamp.proto\">\n\x03Tag\x12\x0b\n\x03key\x18\x01 \x01(\t\x12*\n\x05value\x18\x02 \x01(\x0b\x32\x1b.banyandb.model.v1.TagValue\"?\n\tTagFamily\x12\x0c\n\x04name\x18\x01 \x01(\t\x12$\n\x04tags\x18\x02 \x03(\x0b\x32\x16.banyandb.model.v1.Tag\"\xe9\x04\n\tCondition\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x31\n\x02op\x18\x02 \x01(\x0e\x32%.banyandb.model.v1.Condition.BinaryOp\x12*\n\x05value\x18\x03 \x01(\x0b\x32\x1b.banyandb.model.v1.TagValue\x12>\n\x0cmatch_option\x18\x04 \x01(\x0b\x32(.banyandb.model.v1.Condition.MatchOption\x1a\xad\x01\n\x0bMatchOption\x12\x10\n\x08\x61nalyzer\x18\x01 \x01(\t\x12\x43\n\x08operator\x18\x02 \x01(\x0e\x32\x31.banyandb.model.v1.Condition.MatchOption.Operator\"G\n\x08Operator\x12\x18\n\x14OPERATOR_UNSPECIFIED\x10\x00\x12\x10\n\x0cOPERATOR_AND\x10\x01\x12\x0f\n\x0bOPERATOR_OR\x10\x02\"\xfe\x01\n\x08\x42inaryOp\x12\x19\n\x15\x42INARY_OP_UNSPECIFIED\x10\x00\x12\x10\n\x0c\x42INARY_OP_EQ\x10\x01\x12\x10\n\x0c\x42INARY_OP_NE\x10\x02\x12\x10\n\x0c\x42INARY_OP_LT\x10\x03\x12\x10\n\x0c\x42INARY_OP_GT\x10\x04\x12\x10\n\x0c\x42INARY_OP_LE\x10\x05\x12\x10\n\x0c\x42INARY_OP_GE\x10\x06\x12\x14\n\x10\x42INARY_OP_HAVING\x10\x07\x12\x18\n\x14\x42INARY_OP_NOT_HAVING\x10\x08\x12\x10\n\x0c\x42INARY_OP_IN\x10\t\x12\x14\n\x10\x42INARY_OP_NOT_IN\x10\n\x12\x13\n\x0f\x42INARY_OP_MATCH\x10\x0b\"x\n\x08\x43riteria\x12\x32\n\x02le\x18\x01 \x01(\x0b\x32$.banyandb.model.v1.LogicalExpressionH\x00\x12\x31\n\tcondition\x18\x02 \x01(\x0b\x32\x1c.banyandb.model.v1.ConditionH\x00\x42\x05\n\x03\x65xp\"\xf6\x01\n\x11LogicalExpression\x12:\n\x02op\x18\x01 \x01(\x0e\x32..banyandb.model.v1.LogicalExpression.LogicalOp\x12)\n\x04left\x18\x02 \x01(\x0b\x32\x1b.banyandb.model.v1.Criteria\x12*\n\x05right\x18\x03 \x01(\x0b\x32\x1b.banyandb.model.v1.Criteria\"N\n\tLogicalOp\x12\x1a\n\x16LOGICAL_OP_UNSPECIFIED\x10\x00\x12\x12\n\x0eLOGICAL_OP_AND\x10\x01\x12\x11\n\rLOGICAL_OP_OR\x10\x02\"L\n\nQueryOrder\x12\x17\n\x0findex_rule_name\x18\x01 \x01(\t\x12%\n\x04sort\x18\x02 \x01(\x0e\x32\x17.banyandb.model.v1.Sort\"z\n\rTagProjection\x12@\n\x0ctag_families\x18\x01 \x03(\x0b\x32*.banyandb.model.v1.TagProjection.TagFamily\x1a\'\n\tTagFamily\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04tags\x18\x02 \x03(\t\"_\n\tTimeRange\x12)\n\x05\x62\x65gin\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\'\n\x03\x65nd\x18\x02 \x01(\x0b\x32\x1a.google.protobuf.Timestamp*9\n\x04Sort\x12\x14\n\x10SORT_UNSPECIFIED\x10\x00\x12\r\n\tSORT_DESC\x10\x01\x12\x0c\n\x08SORT_ASC\x10\x02\x42l\n\'org.apache.skywalking.banyandb.model.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/model/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.model.v1.query_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n\'org.apache.skywalking.banyandb.model.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/model/v1'
  _SORT._serialized_start=1536
  _SORT._serialized_end=1593
  _TAG._serialized_start=117
  _TAG._serialized_end=179
  _TAGFAMILY._serialized_start=181
  _TAGFAMILY._serialized_end=244
  _CONDITION._serialized_start=247
  _CONDITION._serialized_end=864
  _CONDITION_MATCHOPTION._serialized_start=434
  _CONDITION_MATCHOPTION._serialized_end=607
  _CONDITION_MATCHOPTION_OPERATOR._serialized_start=536
  _CONDITION_MATCHOPTION_OPERATOR._serialized_end=607
  _CONDITION_BINARYOP._serialized_start=610
  _CONDITION_BINARYOP._serialized_end=864
  _CRITERIA._serialized_start=866
  _CRITERIA._serialized_end=986
  _LOGICALEXPRESSION._serialized_start=989
  _LOGICALEXPRESSION._serialized_end=1235
  _LOGICALEXPRESSION_LOGICALOP._serialized_start=1157
  _LOGICALEXPRESSION_LOGICALOP._serialized_end=1235
  _QUERYORDER._serialized_start=1237
  _QUERYORDER._serialized_end=1313
  _TAGPROJECTION._serialized_start=1315
  _TAGPROJECTION._serialized_end=1437
  _TAGPROJECTION_TAGFAMILY._serialized_start=1398
  _TAGPROJECTION_TAGFAMILY._serialized_end=1437
  _TIMERANGE._serialized_start=1439
  _TIMERANGE._serialized_end=1534
# @@protoc_insertion_point(module_scope)
