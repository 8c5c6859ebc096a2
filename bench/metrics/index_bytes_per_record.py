"""Snapshot (``core/device.py`` ``GLINSnapshot``): the bytes of the distinct
device storages the published snapshot holds (its fields and the tables
cached on it), per record."""


def read(rec):
    if not rec.on_card or not rec.held["index"]:
        return None
    return rec.held["index"] / rec.records
