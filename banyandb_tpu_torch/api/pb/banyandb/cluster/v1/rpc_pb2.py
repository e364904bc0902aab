# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/cluster/v1/rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.model.v1 import write_pb2 as banyandb_dot_model_dot_v1_dot_write__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1d\x62\x61nyandb/cluster/v1/rpc.proto\x12\x13\x62\x61nyandb.cluster.v1\x1a\x1d\x62\x61nyandb/model/v1/write.proto\"g\n\x0bVersionInfo\x12\x1b\n\x13\x66ile_format_version\x18\x01 \x01(\t\x12&\n\x1e\x63ompatible_file_format_version\x18\x02 \x03(\t\x12\x13\n\x0b\x61pi_version\x18\x03 \x01(\t\"\xc1\x01\n\x14VersionCompatibility\x12\x11\n\tsupported\x18\x01 \x01(\x08\x12\x1a\n\x12server_api_version\x18\x02 \x01(\t\x12\x1e\n\x16supported_api_versions\x18\x03 \x03(\t\x12\"\n\x1aserver_file_format_version\x18\x04 \x01(\t\x12&\n\x1esupported_file_format_versions\x18\x05 \x03(\t\x12\x0e\n\x06reason\x18\x06 \x01(\t\"\xd7\x01\n\x0bSendRequest\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x12\n\nmessage_id\x18\x02 \x01(\x04\x12\x0c\n\x04\x62ody\x18\x03 \x01(\x0c\x12\x11\n\tbatch_mod\x18\x04 \x01(\x08\x12\x36\n\x0cversion_info\x18\x05 \x01(\x0b\x32 .banyandb.cluster.v1.VersionInfo\x12\r\n\x05group\x18\x06 \x01(\t\x12\x13\n\x0bsender_node\x18\x07 \x01(\t\x12\x13\n\x0bsender_role\x18\x08 \x01(\t\x12\x13\n\x0bsender_tier\x18\t \x01(\t\"\xb4\x01\n\x0cSendResponse\x12\x12\n\nmessage_id\x18\x01 \x01(\x04\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\x0c\n\x04\x62ody\x18\x03 \x01(\x0c\x12)\n\x06status\x18\x04 \x01(\x0e\x32\x19.banyandb.model.v1.Status\x12H\n\x15version_compatibility\x18\x05 \x01(\x0b\x32).banyandb.cluster.v1.VersionCompatibility\"*\n\x12HealthCheckRequest\x12\x14\n\x0cservice_name\x18\x01 \x01(\t\"e\n\x13HealthCheckResponse\x12\x14\n\x0cservice_name\x18\x01 \x01(\t\x12)\n\x06status\x18\x02 \x01(\x0e\x32\x19.banyandb.model.v1.Status\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"\xce\x02\n\x0fSyncPartRequest\x12\x12\n\nsession_id\x18\x01 \x01(\t\x12\x13\n\x0b\x63hunk_index\x18\x02 \x01(\r\x12\x12\n\nchunk_data\x18\x04 \x01(\x0c\x12\x16\n\x0e\x63hunk_checksum\x18\x05 \x01(\t\x12\x31\n\nparts_info\x18\x06 \x03(\x0b\x32\x1d.banyandb.cluster.v1.PartInfo\x12\x35\n\x08metadata\x18\x07 \x01(\x0b\x32!.banyandb.cluster.v1.SyncMetadataH\x00\x12\x39\n\ncompletion\x18\x08 \x01(\x0b\x32#.banyandb.cluster.v1.SyncCompletionH\x00\x12\x36\n\x0cversion_info\x18\t \x01(\x0b\x32 .banyandb.cluster.v1.VersionInfoB\t\n\x07\x63ontent\"\x92\x02\n\x08PartInfo\x12\n\n\x02id\x18\x01 \x01(\x04\x12,\n\x05\x66iles\x18\x02 \x03(\x0b\x32\x1d.banyandb.cluster.v1.FileInfo\x12\x1d\n\x15\x63ompressed_size_bytes\x18\x03 \x01(\x04\x12\x1f\n\x17uncompressed_size_bytes\x18\x04 \x01(\x04\x12\x13\n\x0btotal_count\x18\x05 \x01(\x04\x12\x14\n\x0c\x62locks_count\x18\x06 \x01(\x04\x12\x15\n\rmin_timestamp\x18\x07 \x01(\x03\x12\x15\n\rmax_timestamp\x18\x08 \x01(\x03\x12\x0f\n\x07min_key\x18\t \x01(\x03\x12\x0f\n\x07max_key\x18\n \x01(\x03\x12\x11\n\tpart_type\x18\x0b \x01(\t\"6\n\x08\x46ileInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\r\x12\x0c\n\x04size\x18\x03 \x01(\r\"\xa5\x01\n\x0cSyncMetadata\x12\r\n\x05group\x18\x01 \x01(\t\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\r\n\x05topic\x18\x04 \x01(\t\x12\x11\n\ttimestamp\x18\x06 \x01(\x03\x12\x13\n\x0btotal_parts\x18\x07 \x01(\r\x12\x13\n\x0bsender_node\x18\x08 \x01(\t\x12\x13\n\x0bsender_role\x18\t \x01(\t\x12\x13\n\x0bsender_tier\x18\n \x01(\t\"Z\n\x0eSyncCompletion\x12\x18\n\x10total_bytes_sent\x18\x01 \x01(\x04\x12\x18\n\x10total_parts_sent\x18\x02 \x01(\r\x12\x14\n\x0ctotal_chunks\x18\x03 \x01(\r\"\xfb\x01\n\x10SyncPartResponse\x12\x12\n\nsession_id\x18\x01 \x01(\t\x12\x13\n\x0b\x63hunk_index\x18\x02 \x01(\r\x12/\n\x06status\x18\x03 \x01(\x0e\x32\x1f.banyandb.cluster.v1.SyncStatus\x12\r\n\x05\x65rror\x18\x04 \x01(\t\x12\x34\n\x0bsync_result\x18\x05 \x01(\x0b\x32\x1f.banyandb.cluster.v1.SyncResult\x12H\n\x15version_compatibility\x18\x06 \x01(\x0b\x32).banyandb.cluster.v1.VersionCompatibility\"\xb9\x01\n\nSyncResult\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x1c\n\x14total_bytes_received\x18\x02 \x01(\x04\x12\x13\n\x0b\x64uration_ms\x18\x03 \x01(\x03\x12\x17\n\x0f\x63hunks_received\x18\x04 \x01(\r\x12\x16\n\x0eparts_received\x18\x05 \x01(\r\x12\x36\n\rparts_results\x18\x06 \x03(\x0b\x32\x1f.banyandb.cluster.v1.PartResult\"E\n\nPartResult\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\x17\n\x0f\x62ytes_processed\x18\x03 \x01(\r*\xc3\x02\n\nSyncStatus\x12\x1b\n\x17SYNC_STATUS_UNSPECIFIED\x10\x00\x12\x1e\n\x1aSYNC_STATUS_CHUNK_RECEIVED\x10\x01\x12\'\n#SYNC_STATUS_CHUNK_CHECKSUM_MISMATCH\x10\x02\x12\"\n\x1eSYNC_STATUS_CHUNK_OUT_OF_ORDER\x10\x03\x12!\n\x1dSYNC_STATUS_SESSION_NOT_FOUND\x10\x04\x12\x1d\n\x19SYNC_STATUS_SYNC_COMPLETE\x10\x05\x12#\n\x1fSYNC_STATUS_VERSION_UNSUPPORTED\x10\x06\x12\'\n#SYNC_STATUS_FORMAT_VERSION_MISMATCH\x10\x07\x12\x1b\n\x17SYNC_STATUS_SERVER_BUSY\x10\x08\x32\xbc\x01\n\x07Service\x12O\n\x04Send\x12 .banyandb.cluster.v1.SendRequest\x1a!.banyandb.cluster.v1.SendResponse(\x01\x30\x01\x12`\n\x0bHealthCheck\x12\'.banyandb.cluster.v1.HealthCheckRequest\x1a(.banyandb.cluster.v1.HealthCheckResponse2q\n\x12\x43hunkedSyncService\x12[\n\x08SyncPart\x12$.banyandb.cluster.v1.SyncPartRequest\x1a%.banyandb.cluster.v1.SyncPartResponse(\x01\x30\x01\x42\x45ZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/cluster/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.cluster.v1.rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'ZCgithub.com/apache/skywalking-banyandb/api/proto/banyandb/cluster/v1'
  _SYNCSTATUS._serialized_start=2378
  _SYNCSTATUS._serialized_end=2701
  _VERSIONINFO._serialized_start=85
  _VERSIONINFO._serialized_end=188
  _VERSIONCOMPATIBILITY._serialized_start=191
  _VERSIONCOMPATIBILITY._serialized_end=384
  _SENDREQUEST._serialized_start=387
  _SENDREQUEST._serialized_end=602
  _SENDRESPONSE._serialized_start=605
  _SENDRESPONSE._serialized_end=785
  _HEALTHCHECKREQUEST._serialized_start=787
  _HEALTHCHECKREQUEST._serialized_end=829
  _HEALTHCHECKRESPONSE._serialized_start=831
  _HEALTHCHECKRESPONSE._serialized_end=932
  _SYNCPARTREQUEST._serialized_start=935
  _SYNCPARTREQUEST._serialized_end=1269
  _PARTINFO._serialized_start=1272
  _PARTINFO._serialized_end=1546
  _FILEINFO._serialized_start=1548
  _FILEINFO._serialized_end=1602
  _SYNCMETADATA._serialized_start=1605
  _SYNCMETADATA._serialized_end=1770
  _SYNCCOMPLETION._serialized_start=1772
  _SYNCCOMPLETION._serialized_end=1862
  _SYNCPARTRESPONSE._serialized_start=1865
  _SYNCPARTRESPONSE._serialized_end=2116
  _SYNCRESULT._serialized_start=2119
  _SYNCRESULT._serialized_end=2304
  _PARTRESULT._serialized_start=2306
  _PARTRESULT._serialized_end=2375
  _SERVICE._serialized_start=2704
  _SERVICE._serialized_end=2892
  _CHUNKEDSYNCSERVICE._serialized_start=2894
  _CHUNKEDSYNCSERVICE._serialized_end=3007
# @@protoc_insertion_point(module_scope)
