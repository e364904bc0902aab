# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/measure/v1/write.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import common_pb2 as banyandb_dot_common_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import common_pb2 as banyandb_dot_model_dot_v1_dot_common__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1f\x62\x61nyandb/measure/v1/write.proto\x12\x13\x62\x61nyandb.measure.v1\x1a\x1f\x62\x61nyandb/common/v1/common.proto\x1a\x1e\x62\x61nyandb/model/v1/common.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"0\n\rTagFamilySpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\ttag_names\x18\x02 \x03(\t\"a\n\rDataPointSpec\x12;\n\x0ftag_family_spec\x18\x01 \x03(\x0b\x32\".banyandb.measure.v1.TagFamilySpec\x12\x13\n\x0b\x66ield_names\x18\x02 \x03(\t\"\xbb\x01\n\x0e\x44\x61taPointValue\x12-\n\ttimestamp\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12:\n\x0ctag_families\x18\x02 \x03(\x0b\x32$.banyandb.model.v1.TagFamilyForWrite\x12-\n\x06\x66ields\x18\x03 \x03(\x0b\x32\x1d.banyandb.model.v1.FieldValue\x12\x0f\n\x07version\x18\x04 \x01(\x03\"\xc8\x01\n\x0cWriteRequest\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\x37\n\ndata_point\x18\x02 \x01(\x0b\x32#.banyandb.measure.v1.DataPointValue\x12\x12\n\nmessage_id\x18\x03 \x01(\x04\x12;\n\x0f\x64\x61ta_point_spec\x18\x04 \x01(\x0b\x32\".banyandb.measure.v1.DataPointSpec\"c\n\rWriteResponse\x12\x12\n\nmessage_id\x18\x01 \x01(\x04\x12\x0e\n\x06status\x18\x02 \x01(\t\x12.\n\x08metadata\x18\x03 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\"\x90\x01\n\x14InternalWriteRequest\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12\x32\n\rentity_values\x18\x02 \x03(\x0b\x32\x1b.banyandb.model.v1.TagValue\x12\x32\n\x07request\x18\x03 \x01(\x0b\x32!.banyandb.measure.v1.WriteRequestBp\n)org.apache.skywalking.banyandb.measure.v1ZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/measure/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.measure.v1.write_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n)org.apache.skywalking.banyandb.measure.v1ZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/measure/v1'
  _TAGFAMILYSPEC._serialized_start=154
  _TAGFAMILYSPEC._serialized_end=202
  _DATAPOINTSPEC._serialized_start=204
  _DATAPOINTSPEC._serialized_end=301
  _DATAPOINTVALUE._serialized_start=304
  _DATAPOINTVALUE._serialized_end=491
  _WRITEREQUEST._serialized_start=494
  _WRITEREQUEST._serialized_end=694
  _WRITERESPONSE._serialized_start=696
  _WRITERESPONSE._serialized_end=795
  _INTERNALWRITEREQUEST._serialized_start=798
  _INTERNALWRITEREQUEST._serialized_end=942
# @@protoc_insertion_point(module_scope)
