"""Persistent BLCO tensor store: the disk tier of the memory hierarchy.

The port of ``repro.store`` (device ⊂ host ⊂ disk):

    format    versioned, checksummed ``.blco`` file layout, byte for byte
              the JAX package's; launches are stored reservation-padded,
              so a launch is read straight into the streaming ring
              (``save_blco`` / ``open_blco`` / ``StoredBLCO``)
    plan      ``DiskStreamedPlan`` — the disk-resident ExecutionPlan,
              feeding the card's ring of reservations from the file with
              a bounded host window

The service's persistence (``repro.store.snapshot``) is ported with the
service.
"""
from .format import (SECTION_ALIGN, VERSION, DiskChunkSource, StoredBLCO,
                     StoreCorruptionError, StoreError, StoreFormatError,
                     open_blco, save_blco)
from .plan import DiskStreamedPlan

__all__ = [
    "SECTION_ALIGN", "VERSION", "DiskChunkSource", "StoredBLCO",
    "StoreCorruptionError", "StoreError", "StoreFormatError",
    "open_blco", "save_blco", "DiskStreamedPlan",
]
