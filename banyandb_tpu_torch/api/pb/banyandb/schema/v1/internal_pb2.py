# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/schema/v1/internal.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.model.v1 import query_pb2 as banyandb_dot_model_dot_v1_dot_query__pb2
from banyandb_tpu_torch.api.pb.banyandb.property.v1 import property_pb2 as banyandb_dot_property_dot_v1_dot_property__pb2
from banyandb_tpu_torch.api.pb.banyandb.property.v1 import rpc_pb2 as banyandb_dot_property_dot_v1_dot_rpc__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n!banyandb/schema/v1/internal.proto\x12\x12\x62\x61nyandb.schema.v1\x1a\x1d\x62\x61nyandb/model/v1/query.proto\x1a#banyandb/property/v1/property.proto\x1a\x1e\x62\x61nyandb/property/v1/rpc.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"G\n\x13InsertSchemaRequest\x12\x30\n\x08property\x18\x01 \x01(\x0b\x32\x1e.banyandb.property.v1.Property\"\x16\n\x14InsertSchemaResponse\"G\n\x13UpdateSchemaRequest\x12\x30\n\x08property\x18\x01 \x01(\x0b\x32\x1e.banyandb.property.v1.Property\"\x16\n\x14UpdateSchemaResponse\"G\n\x12ListSchemasRequest\x12\x31\n\x05query\x18\x01 \x01(\x0b\x32\".banyandb.property.v1.QueryRequest\"_\n\x13ListSchemasResponse\x12\x32\n\nproperties\x18\x01 \x03(\x0b\x32\x1e.banyandb.property.v1.Property\x12\x14\n\x0c\x64\x65lete_times\x18\x02 \x03(\x03\"y\n\x13\x44\x65leteSchemaRequest\x12\x33\n\x06\x64\x65lete\x18\x01 \x01(\x0b\x32#.banyandb.property.v1.DeleteRequest\x12-\n\tupdate_at\x18\x02 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"%\n\x14\x44\x65leteSchemaResponse\x12\r\n\x05\x66ound\x18\x01 \x01(\x08\"\\\n\x13RepairSchemaRequest\x12\x30\n\x08property\x18\x01 \x01(\x0b\x32\x1e.banyandb.property.v1.Property\x12\x13\n\x0b\x64\x65lete_time\x18\x02 \x01(\x03\"\x16\n\x14RepairSchemaResponse\"\\\n\x13WatchSchemasRequest\x12-\n\x08\x63riteria\x18\x01 \x01(\x0b\x32\x1b.banyandb.model.v1.Criteria\x12\x16\n\x0etag_projection\x18\x02 \x03(\t\"\xad\x01\n\x14WatchSchemasResponse\x12\x37\n\nevent_type\x18\x01 \x01(\x0e\x32#.banyandb.schema.v1.SchemaEventType\x12\x30\n\x08property\x18\x02 \x01(\x0b\x32\x1e.banyandb.property.v1.Property\x12\x15\n\rmetadata_only\x18\x03 \x01(\x08\x12\x13\n\x0b\x64\x65lete_time\x18\x04 \x01(\x03*\xb1\x01\n\x0fSchemaEventType\x12!\n\x1dSCHEMA_EVENT_TYPE_UNSPECIFIED\x10\x00\x12\x1c\n\x18SCHEMA_EVENT_TYPE_INSERT\x10\x01\x12\x1c\n\x18SCHEMA_EVENT_TYPE_UPDATE\x10\x02\x12\x1c\n\x18SCHEMA_EVENT_TYPE_DELETE\x10\x03\x12!\n\x1dSCHEMA_EVENT_TYPE_REPLAY_DONE\x10\x04\x32\x87\x04\n\x17SchemaManagementService\x12\x61\n\x0cInsertSchema\x12\'.banyandb.schema.v1.InsertSchemaRequest\x1a(.banyandb.schema.v1.InsertSchemaResponse\x12\x61\n\x0cUpdateSchema\x12\'.banyandb.schema.v1.UpdateSchemaRequest\x1a(.banyandb.schema.v1.UpdateSchemaResponse\x12`\n\x0bListSchemas\x12&.banyandb.schema.v1.ListSchemasRequest\x1a\'.banyandb.schema.v1.ListSchemasResponse0\x01\x12\x61\n\x0c\x44\x65leteSchema\x12\'.banyandb.schema.v1.DeleteSchemaRequest\x1a(.banyandb.schema.v1.DeleteSchemaResponse\x12\x61\n\x0cRepairSchema\x12\'.banyandb.schema.v1.RepairSchemaRequest\x1a(.banyandb.schema.v1.RepairSchemaResponse2|\n\x13SchemaUpdateService\x12\x65\n\x0cWatchSchemas\x12\'.banyandb.schema.v1.WatchSchemasRequest\x1a(.banyandb.schema.v1.WatchSchemasResponse(\x01\x30\x01\x42n\n(org.apache.skywalking.banyandb.schema.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/schema/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.schema.v1.internal_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n(org.apache.skywalking.banyandb.schema.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/schema/v1'
  _SCHEMAEVENTTYPE._serialized_start=1105
  _SCHEMAEVENTTYPE._serialized_end=1282
  _INSERTSCHEMAREQUEST._serialized_start=190
  _INSERTSCHEMAREQUEST._serialized_end=261
  _INSERTSCHEMARESPONSE._serialized_start=263
  _INSERTSCHEMARESPONSE._serialized_end=285
  _UPDATESCHEMAREQUEST._serialized_start=287
  _UPDATESCHEMAREQUEST._serialized_end=358
  _UPDATESCHEMARESPONSE._serialized_start=360
  _UPDATESCHEMARESPONSE._serialized_end=382
  _LISTSCHEMASREQUEST._serialized_start=384
  _LISTSCHEMASREQUEST._serialized_end=455
  _LISTSCHEMASRESPONSE._serialized_start=457
  _LISTSCHEMASRESPONSE._serialized_end=552
  _DELETESCHEMAREQUEST._serialized_start=554
  _DELETESCHEMAREQUEST._serialized_end=675
  _DELETESCHEMARESPONSE._serialized_start=677
  _DELETESCHEMARESPONSE._serialized_end=714
  _REPAIRSCHEMAREQUEST._serialized_start=716
  _REPAIRSCHEMAREQUEST._serialized_end=808
  _REPAIRSCHEMARESPONSE._serialized_start=810
  _REPAIRSCHEMARESPONSE._serialized_end=832
  _WATCHSCHEMASREQUEST._serialized_start=834
  _WATCHSCHEMASREQUEST._serialized_end=926
  _WATCHSCHEMASRESPONSE._serialized_start=929
  _WATCHSCHEMASRESPONSE._serialized_end=1102
  _SCHEMAMANAGEMENTSERVICE._serialized_start=1285
  _SCHEMAMANAGEMENTSERVICE._serialized_end=1804
  _SCHEMAUPDATESERVICE._serialized_start=1806
  _SCHEMAUPDATESERVICE._serialized_end=1930
# @@protoc_insertion_point(module_scope)
