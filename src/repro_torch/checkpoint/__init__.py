from .store import SnapshotStore, version_sort_key

__all__ = ["SnapshotStore", "version_sort_key"]
