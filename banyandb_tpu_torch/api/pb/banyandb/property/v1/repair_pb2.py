# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/property/v1/repair.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.property.v1 import property_pb2 as banyandb_dot_property_dot_v1_dot_property__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n!banyandb/property/v1/repair.proto\x12\x14\x62\x61nyandb.property.v1\x1a#banyandb/property/v1/property.proto\"*\n\x0bTreeSlotSHA\x12\x0c\n\x04slot\x18\x01 \x01(\x05\x12\r\n\x05value\x18\x02 \x01(\t\"O\n\x0cTreeLeafNode\x12\x12\n\nslot_index\x18\x01 \x01(\x05\x12\x0e\n\x06\x65xists\x18\x02 \x01(\x08\x12\x0e\n\x06\x65ntity\x18\x03 \x01(\t\x12\x0b\n\x03sha\x18\x04 \x01(\t\"=\n\x08TreeRoot\x12\r\n\x05group\x18\x01 \x01(\t\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\x10\n\x08root_sha\x18\x03 \x01(\t\"@\n\tTreeSlots\x12\x33\n\x08slot_sha\x18\x01 \x03(\x0b\x32!.banyandb.property.v1.TreeSlotSHA\"!\n\x0fPropertyMissing\x12\x0e\n\x06\x65ntity\x18\x01 \x01(\t\"9\n\x0bRootCompare\x12\x12\n\ntree_found\x18\x01 \x01(\x08\x12\x16\n\x0eroot_sha_match\x18\x02 \x01(\x08\"F\n\x11\x44ifferTreeSummary\x12\x31\n\x05nodes\x18\x02 \x03(\x0b\x32\".banyandb.property.v1.TreeLeafNode\"a\n\x0cPropertySync\x12\n\n\x02id\x18\x01 \x01(\x0c\x12\x30\n\x08property\x18\x02 \x01(\x0b\x32\x1e.banyandb.property.v1.Property\x12\x13\n\x0b\x64\x65lete_time\x18\x03 \x01(\x03\"\x86\x01\n\x14PropertySyncWithFrom\x12\x38\n\x04\x66rom\x18\x01 \x01(\x0e\x32*.banyandb.property.v1.PropertySyncFromType\x12\x34\n\x08property\x18\x02 \x01(\x0b\x32\".banyandb.property.v1.PropertySync\"\x14\n\x12WaitNextDifferData\"\xc9\x02\n\rRepairRequest\x12\x33\n\ttree_root\x18\x01 \x01(\x0b\x32\x1e.banyandb.property.v1.TreeRootH\x00\x12\x35\n\ntree_slots\x18\x02 \x01(\x0b\x32\x1f.banyandb.property.v1.TreeSlotsH\x00\x12\x41\n\x10property_missing\x18\x03 \x01(\x0b\x32%.banyandb.property.v1.PropertyMissingH\x00\x12;\n\rproperty_sync\x18\x04 \x01(\x0b\x32\".banyandb.property.v1.PropertySyncH\x00\x12\x44\n\x10wait_next_differ\x18\x05 \x01(\x0b\x32(.banyandb.property.v1.WaitNextDifferDataH\x00\x42\x06\n\x04\x64\x61ta\"\xe0\x01\n\x0eRepairResponse\x12\x39\n\x0croot_compare\x18\x01 \x01(\x0b\x32!.banyandb.property.v1.RootCompareH\x00\x12\x46\n\x13\x64iffer_tree_summary\x18\x02 \x01(\x0b\x32\'.banyandb.property.v1.DifferTreeSummaryH\x00\x12\x43\n\rproperty_sync\x18\x03 \x01(\x0b\x32*.banyandb.property.v1.PropertySyncWithFromH\x00\x42\x06\n\x04\x64\x61ta*\x86\x01\n\x14PropertySyncFromType\x12\'\n#PROPERTY_SYNC_FROM_TYPE_UNSPECIFIED\x10\x00\x12#\n\x1fPROPERTY_SYNC_FROM_TYPE_MISSING\x10\x01\x12 \n\x1cPROPERTY_SYNC_FROM_TYPE_SYNC\x10\x02\x32j\n\rRepairService\x12Y\n\x06Repair\x12#.banyandb.property.v1.RepairRequest\x1a$.banyandb.property.v1.RepairResponse\"\x00(\x01\x30\x01\x42r\n*org.apache.skywalking.banyandb.property.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/property/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.property.v1.repair_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n*org.apache.skywalking.banyandb.property.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/property/v1'
  _PROPERTYSYNCFROMTYPE._serialized_start=1334
  _PROPERTYSYNCFROMTYPE._serialized_end=1468
  _TREESLOTSHA._serialized_start=96
  _TREESLOTSHA._serialized_end=138
  _TREELEAFNODE._serialized_start=140
  _TREELEAFNODE._serialized_end=219
  _TREEROOT._serialized_start=221
  _TREEROOT._serialized_end=282
  _TREESLOTS._serialized_start=284
  _TREESLOTS._serialized_end=348
  _PROPERTYMISSING._serialized_start=350
  _PROPERTYMISSING._serialized_end=383
  _ROOTCOMPARE._serialized_start=385
  _ROOTCOMPARE._serialized_end=442
  _DIFFERTREESUMMARY._serialized_start=444
  _DIFFERTREESUMMARY._serialized_end=514
  _PROPERTYSYNC._serialized_start=516
  _PROPERTYSYNC._serialized_end=613
  _PROPERTYSYNCWITHFROM._serialized_start=616
  _PROPERTYSYNCWITHFROM._serialized_end=750
  _WAITNEXTDIFFERDATA._serialized_start=752
  _WAITNEXTDIFFERDATA._serialized_end=772
  _REPAIRREQUEST._serialized_start=775
  _REPAIRREQUEST._serialized_end=1104
  _REPAIRRESPONSE._serialized_start=1107
  _REPAIRRESPONSE._serialized_end=1331
  _REPAIRSERVICE._serialized_start=1470
  _REPAIRSERVICE._serialized_end=1576
# @@protoc_insertion_point(module_scope)
