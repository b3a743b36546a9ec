"""Persistent BLCO tensor store: the disk tier of the memory hierarchy.

The port of ``repro.store`` (device ⊂ host ⊂ disk):

    format    versioned, checksummed ``.blco`` file layout, byte for byte
              the JAX package's; launches are stored reservation-padded,
              so a launch is read straight into the streaming ring
              (``save_blco`` / ``open_blco`` / ``StoredBLCO``)
    plan      ``DiskStreamedPlan`` — the disk-resident ExecutionPlan,
              feeding the card's ring of reservations from the file with
              a bounded host window
    snapshot  service persistence: registry contents + per-job ``CPState``
              survive a process restart (``snapshot_service`` /
              ``restore_service``); the manifest and the ``.npz`` keys are
              the JAX package's, so a snapshot opens in either package
"""
from .format import (SECTION_ALIGN, VERSION, DiskChunkSource, StoredBLCO,
                     StoreCorruptionError, StoreError, StoreFormatError,
                     open_blco, save_blco)
from .plan import DiskStreamedPlan
from .snapshot import restore_service, snapshot_service

__all__ = [
    "SECTION_ALIGN", "VERSION", "DiskChunkSource", "StoredBLCO",
    "StoreCorruptionError", "StoreError", "StoreFormatError",
    "open_blco", "save_blco", "DiskStreamedPlan",
    "snapshot_service", "restore_service",
]
