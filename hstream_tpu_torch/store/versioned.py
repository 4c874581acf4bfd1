"""CAS-versioned config store.

Reference: LogDevice's VersionedConfigStore — a compare-and-swap
key/value store for cluster configuration where every value carries a
monotonically increasing version and writers must name the base version
they read (cbits/logdevice/hs_versioned_config_store.cpp:1-173). Built
here on the log store's meta-KV CAS primitive, so values are durable on
the native backend (meta WAL) and versions survive reopen.

Value encoding: u64-LE version || flags u8 (1 = tombstone) || payload.
Deletes write a CAS'd tombstone (never an unconditional remove), so a
concurrent writer's new version cannot be deleted unobserved.
"""

# A copy of hstream_tpu/store/versioned.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import struct

from hstream_tpu_torch.common.errors import StoreError
from hstream_tpu_torch.store.api import LogStore


class VersionMismatch(StoreError):
    """The caller's base_version no longer matches the stored version."""

    def __init__(self, key: str, expected, actual):
        super().__init__(
            f"version mismatch on {key!r}: base {expected}, "
            f"stored {actual}")
        self.expected = expected
        self.actual = actual


class VersionedConfigStore:
    """Versioned config KV over a LogStore's meta KV."""

    PREFIX = "vcs/"

    def __init__(self, store: LogStore):
        self._store = store

    def _k(self, key: str) -> str:
        return self.PREFIX + key

    @staticmethod
    def _encode(version: int, value: bytes, *,
                tombstone: bool = False) -> bytes:
        return struct.pack("<QB", version, 1 if tombstone else 0) + value

    @staticmethod
    def _decode(raw: bytes) -> tuple[int, bool, bytes]:
        version, flags = struct.unpack_from("<QB", raw)
        return version, bool(flags & 1), raw[9:]

    def get(self, key: str) -> tuple[int, bytes] | None:
        """(version, value) or None when the key does not exist (or was
        deleted — tombstones read as absent but keep the version chain
        so a re-create still needs no stale base)."""
        raw = self._store.meta_get(self._k(key))
        if raw is None:
            return None
        version, tomb, value = self._decode(raw)
        return None if tomb else (version, value)

    def put(self, key: str, value: bytes, *,
            base_version: int | None = None) -> int:
        """Write conditioned on the version the caller read:
        base_version=None creates (fails if the key exists), otherwise
        the stored version must equal base_version. Returns the new
        version; raises VersionMismatch on a lost race."""
        raw = self._store.meta_get(self._k(key))
        live_version = None
        if raw is not None:
            v, tomb, _ = self._decode(raw)
            live_version = None if tomb else v
        if base_version is None:
            if live_version is not None:
                raise VersionMismatch(key, None, live_version)
            next_v = (self._decode(raw)[0] + 1) if raw is not None else 1
            new = self._encode(next_v, value)
            if not self._store.meta_cas(self._k(key), raw, new):
                cur = self.get(key)
                raise VersionMismatch(key, None,
                                      cur[0] if cur else None)
            return next_v
        if live_version is None:
            raise VersionMismatch(key, base_version, None)
        if live_version != base_version:
            raise VersionMismatch(key, base_version, live_version)
        new = self._encode(live_version + 1, value)
        if not self._store.meta_cas(self._k(key), raw, new):
            cur = self.get(key)
            raise VersionMismatch(key, base_version,
                                  cur[0] if cur else None)
        return live_version + 1

    def delete(self, key: str, base_version: int) -> None:
        """CAS the key to a tombstone — a concurrent writer's newer
        version can never be deleted unobserved."""
        raw = self._store.meta_get(self._k(key))
        if raw is None:
            raise VersionMismatch(key, base_version, None)
        version, tomb, _ = self._decode(raw)
        if tomb:
            raise VersionMismatch(key, base_version, None)
        if version != base_version:
            raise VersionMismatch(key, base_version, version)
        new = self._encode(version + 1, b"", tombstone=True)
        if not self._store.meta_cas(self._k(key), raw, new):
            cur = self.get(key)
            raise VersionMismatch(key, base_version,
                                  cur[0] if cur else None)

    def keys(self) -> list[str]:
        """Live (non-tombstoned) keys."""
        out = []
        for k in self._store.meta_list(self.PREFIX):
            short = k[len(self.PREFIX):]
            if self.get(short) is not None:
                out.append(short)
        return out
