"""Case storage and the metadata columns for on-device filtering."""

from .columns import MetadataColumns, date_to_int, int_to_date
from .store import StorageManager, StorageStats

__all__ = [
    "MetadataColumns",
    "StorageManager",
    "StorageStats",
    "date_to_int",
    "int_to_date",
]
