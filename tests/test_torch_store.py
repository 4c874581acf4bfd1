"""The port's log store (hstream_tpu_torch/store/) against the JAX
package's (hstream_tpu/store/), over the in-memory and the native
segment-log backends.

Each case of tests/test_store.py, the server-free cases of
tests/test_store_durability.py and the cases of
tests/test_versioned_config.py runs through both packages, each on a
store of its own: the case's assertions hold in both, and what each
observed (payloads, LSNs, gaps, attributes, versions) is equal. Then the
state they share: at a pinned append time the two native stores write
the same bytes to disk, a directory written by either package opens and
reads the same in the other, and a checkpoint written by either resumes
a reader in the other. A store is closed before the other package opens
its directory.
"""

from __future__ import annotations

import importlib
import os
import random
import threading
import time
from types import SimpleNamespace

import pytest

from torch_native import build_reference_libs


def _pkg(name: str) -> SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        name=name, store=mod("store"), api=mod("store.api"),
        native=mod("store.native"), versioned=mod("store.versioned"),
        dedup=mod("store.dedup"), errors=mod("common.errors"))


REF, PORT = _pkg("hstream_tpu"), _pkg("hstream_tpu_torch")
PKGS = (REF, PORT)
BACKENDS = ["mem", "native"]
T0 = 1_700_000_000_000  # a pinned append time


@pytest.fixture(scope="module", autouse=True)
def _reference_libs():
    build_reference_libs()


def _open(pkg, backend: str, root: str):
    if backend == "mem":
        return pkg.store.MemLogStore()
    return pkg.native.NativeLogStore(root)


def _close(store) -> None:
    if hasattr(store, "close"):
        store.close()


def both(backend, tmp_path, case):
    """Run `case(pkg, store, root)` for each package on its own store and
    assert that both observed the same."""
    seen = []
    for pkg in PKGS:
        root = str(tmp_path / pkg.name)
        store = _open(pkg, backend, root)
        try:
            seen.append(case(pkg, store, root))
        finally:
            _close(store)
    assert seen[0] == seen[1], seen
    return seen[1]


def batches(pkg, results):
    return [r for r in results if isinstance(r, pkg.api.DataBatch)]


def view(pkg, results):
    """What a reader returned, as comparable tuples."""
    out = []
    for r in results:
        if isinstance(r, pkg.api.DataBatch):
            out.append(("data", r.logid, r.lsn, r.payloads))
        else:
            out.append(("gap", r.logid, r.gap_type.name, r.lo_lsn,
                        r.hi_lsn))
    return out


def read_all(store, logid, pkg):
    r = store.new_reader()
    r.set_timeout(0)
    r.start_reading(logid, pkg.api.LSN_MIN)
    out = []
    while True:
        got = r.read(256)
        if not got:
            return out
        out.extend(got)


def payloads_of(pkg, items):
    return [p for it in batches(pkg, items) for p in it.payloads]


# ---- tests/test_store.py, through both packages -----------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_append_read_roundtrip(backend, tmp_path):
    def case(pkg, store, root):
        store.create_log(7)
        lsn1 = store.append(7, b"one")
        lsn2 = store.append_batch(7, [b"two", b"three"])
        assert lsn2 > lsn1
        reader = store.new_reader()
        reader.set_timeout(0)
        reader.start_reading(7)
        out = reader.read(10)
        assert [b.payloads for b in batches(pkg, out)] == [
            (b"one",), (b"two", b"three")]
        assert out[0].lsn == lsn1 and out[1].lsn == lsn2
        assert reader.read(10) == []
        return view(pkg, out)

    both(backend, tmp_path, case)


@pytest.mark.parametrize("backend", BACKENDS)
def test_read_from_lsn_and_until(backend, tmp_path):
    def case(pkg, store, root):
        store.create_log(1)
        lsns = [store.append(1, f"r{i}".encode()) for i in range(5)]
        reader = store.new_reader()
        reader.set_timeout(0)
        reader.start_reading(1, from_lsn=lsns[2], until_lsn=lsns[3])
        out = batches(pkg, reader.read(10))
        assert [b.payloads[0] for b in out] == [b"r2", b"r3"]
        assert reader.read(10) == []
        return lsns, view(pkg, out)

    both(backend, tmp_path, case)


@pytest.mark.parametrize("backend", BACKENDS)
def test_trim_surfaces_gap(backend, tmp_path):
    def case(pkg, store, root):
        store.create_log(1)
        lsns = [store.append(1, f"r{i}".encode()) for i in range(4)]
        store.trim(1, lsns[1])
        assert store.trim_point(1) == lsns[1]
        reader = store.new_reader()
        reader.set_timeout(0)
        reader.start_reading(1)
        out = reader.read(10)
        assert isinstance(out[0], pkg.api.GapRecord)
        assert out[0].gap_type == pkg.api.GapType.TRIM
        assert out[0].hi_lsn == lsns[1]
        assert [b.payloads[0] for b in batches(pkg, out)] == [b"r2", b"r3"]
        return view(pkg, out)

    both(backend, tmp_path, case)


@pytest.mark.parametrize("backend", BACKENDS)
def test_blocking_read_wakes_on_append(backend, tmp_path):
    def case(pkg, store, root):
        store.create_log(1)
        reader = store.new_reader()
        reader.set_timeout(5000)
        reader.start_reading(1)
        got = []
        t = threading.Thread(target=lambda: got.extend(reader.read(10)))
        t.start()
        time.sleep(0.05)
        store.append(1, b"wake")
        t.join(timeout=5)
        assert not t.is_alive()
        return [b.payloads for b in batches(pkg, got)]

    assert both(backend, tmp_path, case) == [(b"wake",)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_read_timeout(backend, tmp_path):
    def case(pkg, store, root):
        store.create_log(1)
        reader = store.new_reader()
        reader.set_timeout(50)
        reader.start_reading(1)
        t0 = time.monotonic()
        out = reader.read(10)
        assert time.monotonic() - t0 >= 0.04
        return out

    assert both(backend, tmp_path, case) == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_find_time_and_tail(backend, tmp_path):
    def case(pkg, store, root):
        store.create_log(1)
        assert store.is_log_empty(1)
        lsn = store.append(1, b"x")
        assert store.tail_lsn(1) == lsn
        assert not store.is_log_empty(1)
        assert store.find_time(1, 0) == lsn
        assert store.find_time(1, int(time.time() * 1000) + 10_000) \
            == lsn + 1
        return lsn

    both(backend, tmp_path, case)


@pytest.mark.parametrize("backend", BACKENDS)
def test_missing_log(backend, tmp_path):
    def case(pkg, store, root):
        with pytest.raises(pkg.errors.LogNotFound):
            store.append(99, b"x")
        with pytest.raises(pkg.errors.LogNotFound):
            store.new_reader().start_reading(99)
        return True

    both(backend, tmp_path, case)


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_api(backend, tmp_path):
    def case(pkg, store, root):
        random.seed(11)  # the same logids in both packages
        api = pkg.store.StreamApi(store)
        logid = api.create_stream("s1", replication_factor=3)
        assert api.stream_exists("s1")
        assert api.get_logid("s1") == logid
        assert api.stream_meta("s1")["replication_factor"] == 3
        with pytest.raises(pkg.errors.StreamExists):
            api.create_stream("s1")
        vlogid = api.create_stream("s1",
                                   stream_type=pkg.store.StreamType.VIEW)
        assert vlogid != logid
        assert api.find_streams() == ["s1"]
        assert api.find_streams(pkg.store.StreamType.VIEW) == ["s1"]
        api.append("s1", b"data")
        assert store.tail_lsn(logid) != 0
        api.delete_stream("s1")
        assert not api.stream_exists("s1")
        with pytest.raises(pkg.errors.StreamNotFound):
            api.get_logid("s2")
        with pytest.raises(pkg.errors.StreamNotFound):
            api.get_logid("s1")
        return logid, vlogid

    both(backend, tmp_path, case)


CKP_KINDS = ["mem", "file", "log"]


def _ckp_store(pkg, kind, store, root):
    if kind == "mem":
        return pkg.store.MemCheckpointStore()
    if kind == "file":
        return pkg.store.FileCheckpointStore(root + ".ckp.json")
    return pkg.store.LogCheckpointStore(store)


@pytest.mark.parametrize("kind", CKP_KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_store(backend, kind, tmp_path):
    def case(pkg, store, root):
        cs = _ckp_store(pkg, kind, store, root)
        assert cs.get("c1", 1) is None
        cs.update("c1", 1, 100)
        cs.update_multi("c1", {2: 200, 3: 300})
        cs.update("c2", 1, 999)
        assert cs.get("c1", 1) == 100
        assert cs.all_for("c1") == {1: 100, 2: 200, 3: 300}
        cs.update("c1", 1, 150)
        assert cs.get("c1", 1) == 150
        cs.remove("c1")
        assert cs.all_for("c1") == {}
        return cs.all_for("c2")

    assert both(backend, tmp_path, case) == {1: 999}


def test_file_checkpoint_persistence(tmp_path):
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg.name}.json")
        pkg.store.FileCheckpointStore(path).update("c1", 5, 42)
        assert pkg.store.FileCheckpointStore(path).get("c1", 5) == 42
    with open(tmp_path / "hstream_tpu.json", "rb") as a, \
            open(tmp_path / "hstream_tpu_torch.json", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("backend", BACKENDS)
def test_log_checkpoint_replay_and_compaction(backend, tmp_path):
    def case(pkg, store, root):
        cs = pkg.store.LogCheckpointStore(store, compact_every=4)
        for i in range(10):
            cs.update("c1", 1, i)
        cs.update("c2", 7, 70)
        cs2 = pkg.store.LogCheckpointStore(store)
        return cs2.get("c1", 1), cs2.get("c2", 7)

    assert both(backend, tmp_path, case) == (9, 70)


@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpointed_reader(backend, tmp_path):
    def case(pkg, store, root):
        random.seed(5)
        api = pkg.store.StreamApi(store)
        logid = api.create_stream("s")
        for i in range(5):
            store.append(logid, f"r{i}".encode())
        cs = pkg.store.MemCheckpointStore()
        r1 = pkg.store.CheckpointedReader("task-1", store.new_reader(), cs)
        r1.set_timeout(0)
        assert r1.start_reading_from_checkpoint(logid) == 1
        out = batches(pkg, r1.read(3))
        r1.write_checkpoints({logid: out[-1].lsn})
        r2 = pkg.store.CheckpointedReader("task-1", store.new_reader(), cs)
        r2.set_timeout(0)
        r2.start_reading_from_checkpoint(logid)
        out2 = batches(pkg, r2.read(10))
        assert [b.payloads[0] for b in out2] == [b"r3", b"r4"]
        return view(pkg, out), view(pkg, out2)

    both(backend, tmp_path, case)


# ---- tests/test_store_durability.py's server-free cases ----------------------

def native_both(tmp_path, case):
    """`case(pkg, root)` for each package on a directory of its own."""
    seen = [case(pkg, str(tmp_path / pkg.name)) for pkg in PKGS]
    assert seen[0] == seen[1], seen
    return seen[1]


def seg_files(root, logid):
    d = os.path.join(root, "logs", str(logid))
    return sorted(f for f in os.listdir(d) if f.startswith("seg."))


def test_reopen_preserves_everything(tmp_path):
    def case(pkg, root):
        store = pkg.native.NativeLogStore(root)
        store.create_log(7, pkg.api.LogAttrs(replication_factor=3,
                                             extras={"kind": "stream"}))
        for i in range(10):
            store.append_batch(7, [f"r{i}".encode(), b"x"])
        store.append_batch(7, [b"zlib" * 100],
                           compression=pkg.api.Compression.ZLIB)
        store.meta_put("cfg/a", b"v1")
        store.meta_put("cfg/b", b"v2")
        store.meta_delete("cfg/b")
        tail = store.tail_lsn(7)
        store.close()
        re = pkg.native.NativeLogStore(root)
        try:
            assert re.log_exists(7) and re.tail_lsn(7) == tail
            attrs = re.log_attrs(7)
            assert attrs.replication_factor == 3
            assert attrs.extras == {"kind": "stream"}
            got = payloads_of(pkg, read_all(re, 7, pkg))
            assert got[:2] == [b"r0", b"x"] and got[-1] == b"zlib" * 100
            assert len(got) == 21
            assert re.meta_get("cfg/a") == b"v1"
            assert re.meta_get("cfg/b") is None
            after = re.append_batch(7, [b"after"])
            assert after > tail
            return tail, after, got
        finally:
            re.close()

    native_both(tmp_path, case)


def test_torn_tail_truncated_on_open(tmp_path):
    def case(pkg, root):
        store = pkg.native.NativeLogStore(root)
        store.create_log(9)
        for i in range(5):
            store.append_batch(9, [f"ok{i}".encode()])
        store.close()
        seg = os.path.join(root, "logs", "9", seg_files(root, 9)[-1])
        with open(seg, "ab") as f:
            f.write(b"NSBK" + b"\x01\x02\x03")
        re = pkg.native.NativeLogStore(root)
        got = payloads_of(pkg, read_all(re, 9, pkg))
        assert got == [f"ok{i}".encode() for i in range(5)]
        lsn = re.append_batch(9, [b"new"])
        assert lsn == re.tail_lsn(9)
        re.close()
        re2 = pkg.native.NativeLogStore(root)
        last = payloads_of(pkg, read_all(re2, 9, pkg))
        re2.close()
        assert last[-1] == b"new"
        return lsn, last

    native_both(tmp_path, case)


def test_corrupt_frame_truncates_to_last_good(tmp_path):
    def case(pkg, root):
        store = pkg.native.NativeLogStore(root)
        store.create_log(11)
        for i in range(4):
            store.append_batch(11, [f"keep{i}".encode()])
        store.append_batch(11, [b"doomed-payload-xxxx"])
        store.close()
        seg = os.path.join(root, "logs", "11", seg_files(root, 11)[-1])
        size = os.path.getsize(seg)
        with open(seg, "r+b") as f:
            f.seek(size - 5)
            b = f.read(1)
            f.seek(size - 5)
            f.write(bytes([b[0] ^ 0xFF]))
        re = pkg.native.NativeLogStore(root)
        got = payloads_of(pkg, read_all(re, 11, pkg))
        re.close()
        assert got == [f"keep{i}".encode() for i in range(4)]
        return got

    native_both(tmp_path, case)


def test_meta_wal_compaction_replay(tmp_path):
    def case(pkg, root):
        store = pkg.native.NativeLogStore(root)
        big = b"v" * 4096
        for _ in range(8):
            for i in range(500):
                store.meta_put(f"k{i}", big)
        for i in range(0, 500, 2):
            store.meta_delete(f"k{i}")
        store.meta_put("last", b"final")
        wal = os.path.getsize(os.path.join(root, "meta.wal"))
        assert wal < (4 << 20) + 3 * (1 << 20), wal
        store.close()
        re = pkg.native.NativeLogStore(root)
        try:
            assert re.meta_get("last") == b"final"
            assert re.meta_get("k0") is None and re.meta_get("k2") is None
            assert re.meta_get("k1") == big
            return wal, sorted(re.meta_list("k"))
        finally:
            re.close()

    native_both(tmp_path, case)


def test_async_append_concurrent_first_use(tmp_path):
    def case(pkg, root):
        store = pkg.native.NativeLogStore(root)
        store.create_log(21)
        results: list[list[int]] = [[] for _ in range(8)]
        errs: list[BaseException] = []
        start = threading.Barrier(8)

        def work(t):
            try:
                start.wait(5)
                futs = [store.append_async(21, [f"t{t}b{i}".encode()])
                        for i in range(25)]
                results[t] = [f.result(timeout=15) for f in futs]
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not errs, errs
        lsns = sorted(lsn for r in results for lsn in r)
        assert len(set(lsns)) == 200
        assert store.tail_lsn(21) == lsns[-1]
        store.close()
        return lsns  # the order across threads varies; the set does not

    native_both(tmp_path, case)


def test_trim_survives_reopen(tmp_path):
    def case(pkg, root):
        store = pkg.native.NativeLogStore(root)
        store.create_log(13)
        lsns = [store.append_batch(13, [f"p{i}".encode()])
                for i in range(6)]
        store.trim(13, lsns[2])
        store.close()
        re = pkg.native.NativeLogStore(root)
        try:
            assert re.trim_point(13) == lsns[2]
            items = read_all(re, 13, pkg)
            assert isinstance(items[0], pkg.api.GapRecord)
            assert payloads_of(pkg, items) == [b"p3", b"p4", b"p5"]
            return view(pkg, items)
        finally:
            re.close()

    native_both(tmp_path, case)


def test_async_append_durable_and_ordered(tmp_path):
    def case(pkg, root):
        store = pkg.native.NativeLogStore(root)
        store.create_log(15)
        futs = [store.append_async(15, [f"a{i}".encode()])
                for i in range(50)]
        lsns = [f.result(timeout=10) for f in futs]
        assert lsns == sorted(lsns) and len(set(lsns)) == 50
        assert store.tail_lsn(15) == lsns[-1]
        store.close()
        re = pkg.native.NativeLogStore(root)
        got = payloads_of(pkg, read_all(re, 15, pkg))
        re.close()
        assert got == [f"a{i}".encode() for i in range(50)]
        return lsns

    native_both(tmp_path, case)


def test_async_append_unknown_log_fails_future(tmp_path):
    def case(pkg, root):
        store = pkg.native.NativeLogStore(root)
        fut = store.append_async(999, [b"x"])
        with pytest.raises(Exception) as e:
            fut.result(timeout=10)
        store.close()
        return type(e.value).__name__

    native_both(tmp_path, case)


# ---- tests/test_versioned_config.py ----------------------------------------

def test_create_update_delete_cycle(tmp_path):
    def case(pkg, store, root):
        V = pkg.versioned
        vcs = V.VersionedConfigStore(store)
        assert vcs.get("a") is None
        assert vcs.put("a", b"v1") == 1
        assert vcs.get("a") == (1, b"v1")
        with pytest.raises(V.VersionMismatch):
            vcs.put("a", b"again")
        with pytest.raises(V.VersionMismatch):
            vcs.put("a", b"x", base_version=7)
        assert vcs.put("a", b"v2", base_version=1) == 2
        with pytest.raises(V.VersionMismatch):
            vcs.delete("a", base_version=1)
        vcs.delete("a", base_version=2)
        assert vcs.get("a") is None
        assert vcs.put("a", b"v3") == 4
        vcs.delete("a", base_version=4)
        vcs.put("x", b"1")
        vcs.put("y", b"2")
        return vcs.keys(), store.meta_list("")

    assert both("mem", tmp_path, case)[0] == ["x", "y"]


def test_concurrent_cas_single_winner_per_round(tmp_path):
    def case(pkg, store, root):
        vcs = pkg.versioned.VersionedConfigStore(store)
        vcs.put("c", b"0")
        wins = []
        barrier = threading.Barrier(8)

        def bump(t):
            barrier.wait(5)
            for _ in range(50):
                cur = vcs.get("c")
                try:
                    vcs.put("c", str(int(cur[1]) + 1).encode(),
                            base_version=cur[0])
                    wins.append(t)
                except pkg.versioned.VersionMismatch:
                    pass

        threads = [threading.Thread(target=bump, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        version, value = vcs.get("c")
        # the winners vary from run to run; the invariant does not
        return version == 1 + len(wins), int(value) == len(wins)

    assert both("mem", tmp_path, case) == (True, True)


def test_versions_survive_native_reopen(tmp_path):
    def case(pkg, root):
        store = pkg.native.NativeLogStore(root)
        vcs = pkg.versioned.VersionedConfigStore(store)
        vcs.put("cfg", b"one")
        vcs.put("cfg", b"two", base_version=1)
        store.close()
        re = pkg.native.NativeLogStore(root)
        got = pkg.versioned.VersionedConfigStore(re).get("cfg")
        re.close()
        return got

    assert native_both(tmp_path, case) == (2, b"two")


def _bump_boot_epoch(pkg, config) -> int:
    """The server's boot-epoch CAS (hstream_tpu/server/context.py:271)."""
    for _ in range(16):
        cur = config.get("cluster/boot_epoch")
        try:
            if cur is None:
                config.put("cluster/boot_epoch", b"1")
                return 1
            version, raw = cur
            epoch = int(raw) + 1
            config.put("cluster/boot_epoch", str(epoch).encode(),
                       base_version=version)
            return epoch
        except pkg.versioned.VersionMismatch:
            continue
    raise RuntimeError("boot-epoch CAS kept losing")


def test_boot_epoch_increments_across_boots_of_either_package(tmp_path):
    """The server case (one boot epoch per boot of a store directory)
    without booting a server: the CAS each server context runs at boot
    over the versioned config store, the store reopened by each package
    in turn."""
    root = str(tmp_path / "st")
    for expected, pkg in zip((1, 2, 3, 4), (REF, PORT, REF, PORT)):
        store = pkg.native.NativeLogStore(root)
        config = pkg.versioned.VersionedConfigStore(store)
        assert _bump_boot_epoch(pkg, config) == expected
        store.close()


# ---- the state both packages share ----------------------------------------

def _write_log(pkg, root: str) -> None:
    """A pinned-time workload: two logs, plain and zlib batches, a trim,
    meta keys and a stream."""
    store = pkg.native.NativeLogStore(root)
    random.seed(3)
    api = pkg.store.StreamApi(store)
    sid = api.create_stream("sensors", replication_factor=2)
    store.create_log(42, pkg.api.LogAttrs(extras={"kind": "raw"}))
    for i in range(40):
        store.append_batch(sid, [f"e{i}-{j}".encode() * (1 + j)
                                 for j in range(i % 5 + 1)],
                           append_time_ms=T0 + 200 * i)
        if i % 3 == 0:
            store.append_batch(42, [bytes(range(i % 256)) * 7],
                               pkg.api.Compression.ZLIB,
                               append_time_ms=T0 + 200 * i + 1)
    store.trim(42, 2)
    store.meta_put("cfg/x", b"1")
    store.close()


def _tree(root: str) -> dict[str, bytes]:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_segment_files_are_byte_identical_at_a_pinned_time(tmp_path):
    for pkg in PKGS:
        _write_log(pkg, str(tmp_path / pkg.name))
    a, b = _tree(str(tmp_path / REF.name)), _tree(str(tmp_path / PORT.name))
    assert sorted(a) == sorted(b)
    assert any(k.startswith("logs") and "seg." in k for k in a)
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_a_store_directory_opens_in_the_other_package(tmp_path, writer,
                                                      reader):
    root = str(tmp_path / "st")
    _write_log(writer, root)
    seen = []
    for pkg in (writer, reader):
        store = pkg.native.NativeLogStore(root)
        api = pkg.store.StreamApi(store)
        sid = api.get_logid("sensors")
        seen.append((store.list_logs(), store.log_attrs(42).extras,
                     api.stream_meta("sensors"), store.trim_point(42),
                     store.meta_get("cfg/x"), store.find_time(sid, T0 + 1000),
                     view(pkg, read_all(store, sid, pkg)),
                     view(pkg, read_all(store, 42, pkg))))
        store.close()
    assert seen[0] == seen[1]
    # appends go on in the other package after the reopen
    store = reader.native.NativeLogStore(root)
    lsn = store.append_batch(42, [b"more"], append_time_ms=T0 + 10_000)
    store.close()
    store = writer.native.NativeLogStore(root)
    assert payloads_of(writer, read_all(store, 42, writer))[-1] == b"more"
    assert store.tail_lsn(42) == lsn
    store.close()


@pytest.mark.parametrize("ckp", ["file", "log"])
@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_a_checkpoint_resumes_a_reader_in_the_other_package(tmp_path,
                                                            writer, reader,
                                                            ckp):
    """A CheckpointedReader of one package reads part of a stream and
    writes its checkpoint (a FileCheckpointStore's JSON, or the store's
    checkpoint log); one of the other package resumes from it after the
    store was reopened."""
    root, path = str(tmp_path / "st"), str(tmp_path / "ckp.json")
    _write_log(writer, root)

    def reader_of(pkg, store):
        cs = (pkg.store.FileCheckpointStore(path) if ckp == "file"
              else pkg.store.LogCheckpointStore(store))
        r = pkg.store.CheckpointedReader("q1", store.new_reader(), cs)
        r.set_timeout(0)
        return r

    store = writer.native.NativeLogStore(root)
    sid = writer.store.StreamApi(store).get_logid("sensors")
    r1 = reader_of(writer, store)
    r1.start_reading_from_checkpoint(sid)
    first = batches(writer, r1.read(12))
    r1.write_checkpoints({sid: first[-1].lsn})
    rest_here = batches(writer, r1.read(1000))
    store.close()

    store = reader.native.NativeLogStore(root)
    r2 = reader_of(reader, store)
    r2.start_reading_from_checkpoint(sid)
    rest = batches(reader, r2.read(1000))
    store.close()
    assert [(b.lsn, b.payloads) for b in rest] == \
        [(b.lsn, b.payloads) for b in rest_here]
    assert len(first) + len(rest) == 40
    assert rest[0].lsn == first[-1].lsn + 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_open_store_and_producer_dedup_match(backend, tmp_path):
    """open_store's URI forms, and the producer dedup window (store/
    dedup.py) kept in the store's meta KV, in both packages."""
    def case(pkg, store, root):
        store.create_log(3)
        lock = threading.Lock()
        D = pkg.dedup
        first = D.guarded_append(store, lock, 3, [b"a"], None, "p1", 1)
        again = D.guarded_append(store, lock, 3, [b"a"], None, "p1", 1)
        second = D.guarded_append(store, lock, 3, [b"b"], None, "p1", 2)
        return first, again, second, D.load_window(store, "p1")

    both(backend, tmp_path, case)
    for pkg in PKGS:
        assert isinstance(pkg.store.open_store(None), pkg.store.MemLogStore)
        st = pkg.store.open_store(f"file://{tmp_path}/{pkg.name}-uri",
                                  segment_bytes=1 << 20)
        assert isinstance(st, pkg.native.NativeLogStore)
        st.close()


def test_the_ports_fault_points_answer_to_its_own_registry(tmp_path):
    """The store's chaos probes (store.append, checkpoint.persist) fire
    from the port's own FAULTS singleton (common/faultinject.py), never
    from the JAX package's, and the reverse."""
    from hstream_tpu.common.faultinject import FAULTS as JFAULTS
    from hstream_tpu_torch.common.faultinject import FAULTS, InjectedFault

    stores = {pkg.name: pkg.store.MemLogStore() for pkg in PKGS}
    for st in stores.values():
        st.create_log(1)
    try:
        FAULTS.arm("store.append", "fail:1")
        with pytest.raises(InjectedFault):
            stores[PORT.name].append(1, b"x")
        assert stores[REF.name].append(1, b"x") == 1
        assert stores[PORT.name].append(1, b"x") == 1  # fired once
        assert FAULTS.status()["store.append"]["hits"] >= 2
        assert not JFAULTS.active
    finally:
        FAULTS.disarm()
