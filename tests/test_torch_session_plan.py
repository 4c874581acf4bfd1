"""The key-sharded session step's and merge's table launch (the port's
hstream_tpu_torch/engine/kernels/csrc/session_chain.cuh core_group) on
the CPU: its plain model of the single sort against the reference's
per-shard chain assignment, its sort code, and the host's plan and
argument table.

`parallel.lattice.sharded_chain_slots_ref` keys each entry of a table of
key shards once, by ((g << qbits) | code div S, start), sorts once, and
numbers a shard's chains from the chains of the shards before it. The
reference (hstream_tpu/parallel/lattice.py ShardedSessionLattice) runs
hstream_tpu/engine/lattice.py _session_chain_slots once a shard over
that shard's arena and the whole batch, the records another shard owns
made the sentinel; both must give every entry the same slot (cap =
dropped), exactly.
"""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hstream_tpu.engine import lattice as JL
from hstream_tpu_torch.engine import session_lattice as sl
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.expr import Col
from hstream_tpu_torch.engine.plan import AggKind, AggSpec
from hstream_tpu_torch.parallel import lattice as pl
from hstream_tpu_torch.parallel import make_mesh
from test_torch_session_lattice import TSPEC

SENT = sl.SESSION_SENT_CODE
GAP = 150

# (cap, records, codes, base start): "wrap" puts the starts on both sides
# of the int32 wrap, "overflow" gives shard 0 more chains than its cap
CASES = {"plain": (64, 300, 40, 1_000),
         "wrap": (64, 300, 40, 2**31 - 500),
         "overflow": (16, 400, 200, 0)}


def _wrap32(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def _table(S: int, case: str, seed: int):
    """Per-shard arenas (codes each shard owns, a fifth dead) and one
    batch (a tenth invalid), as (code, start, end) int32 arrays."""
    cap, nb, n_codes, t = CASES[case]
    rng = np.random.default_rng(seed)
    arenas = []
    for s in range(S):
        n = cap if case != "overflow" or s else cap // 2
        own = np.arange(s, n_codes, S)
        code = np.full(cap, SENT, np.int32)
        code[:n] = rng.choice(own, n)
        code[rng.random(cap) < 0.2] = SENT
        t0 = _wrap32(t + rng.integers(0, 400, cap))
        t1 = _wrap32(t0.astype(np.int64) + rng.integers(0, 60, cap))
        arenas.append((code, t0, t1))
    code = rng.integers(0, n_codes, nb).astype(np.int32)
    if case == "overflow":   # shard 0 takes many short chains
        code[: nb // 2] = rng.integers(0, n_codes // S, nb // 2) * S
    code[rng.random(nb) < 0.1] = SENT
    ts = _wrap32(t + rng.integers(0, 2000, nb))
    return cap, arenas, (code, ts, ts)


def _reference(S, shards, cap, arenas, batch):
    """The reference's slots: _session_chain_slots once a shard of the
    table over its arena and the batch, unowned records the sentinel;
    records of shards outside the table dropped."""
    code, t0, t1 = batch
    want_arena, want_batch = [], np.full(len(code), cap, np.int64)
    for s in shards:
        acode, at0, at1 = arenas[s]
        owned = np.remainder(code, S) == s
        bcode = np.where(owned, code, SENT).astype(np.int32)
        dest = np.asarray(JL._session_chain_slots(
            jnp.asarray(np.concatenate([acode, bcode])),
            jnp.asarray(np.concatenate([at0, t0])),
            jnp.asarray(np.concatenate([at1, t1])), GAP, cap))
        dest = np.minimum(dest.astype(np.int64), cap)
        want_arena.append(dest[:cap])
        hit = owned & (code < SENT)
        want_batch[hit] = dest[cap:][hit]
    return np.concatenate(want_arena + [want_batch])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_table_slots_equal_the_reference_per_shard(S, case):
    """Every shard of the mesh in one table: each arena row and record
    gets the reference's slot in its own shard's arena."""
    cap, arenas, batch = _table(S, case, 10 * S + len(case))
    shards = list(range(S))
    ent = [np.concatenate([a[k] for a in arenas] + [batch[k]])
           for k in range(3)]
    got = pl.sharded_chain_slots_ref(
        *(torch.from_numpy(x) for x in ent), shards, S, cap, GAP).numpy()
    want = _reference(S, shards, cap, arenas, batch)
    np.testing.assert_array_equal(got, want)
    kept = got[ent[0] < SENT] < cap
    assert kept.mean() > (0.04 if case == "overflow" else 0.3)
    if case == "overflow":   # shard 0's chains pass its cap: some dropped
        code = np.concatenate([arenas[0][0], batch[0]])
        owned = code[(code < SENT) & (np.remainder(code, S) == 0)]
        assert len(np.unique(owned)) > cap and not kept.all()


@pytest.mark.parametrize("shards", [[0, 2], [3], [1, 2, 3]])
def test_a_partial_table_drops_the_other_shards_records(shards):
    """A card's table of some of the mesh's shards (a mesh over several
    cards, or a split table): its shards' slots are the reference's, the
    records of the shards elsewhere are dropped."""
    S = 4
    cap, arenas, batch = _table(S, "plain", 77 + len(shards))
    ent = [np.concatenate([arenas[s][k] for s in shards] + [batch[k]])
           for k in range(3)]
    got = pl.sharded_chain_slots_ref(
        *(torch.from_numpy(x) for x in ent), shards, S, cap, GAP).numpy()
    np.testing.assert_array_equal(
        got, _reference(S, shards, cap, arenas, batch))
    other = ~np.isin(np.remainder(batch[0], S), shards)
    assert other.any() and (got[len(shards) * cap:][other] == cap).all()


@pytest.mark.parametrize("S", range(1, 17))
def test_sort_code_is_injective_and_fits_the_key(S):
    """(place << qbits) | code div S over every code below 2^22, with
    every shard in the table: one sort code a code, ascending within a
    shard, and at most 23 bits, so with 32 bits of start the key stays
    within the sort's 55 (its top 9 carry a warp rank)."""
    codes = np.arange(SENT, dtype=np.int64)
    qbits = sl.session_qbits(S)
    sc = (np.remainder(codes, S) << qbits) | (codes // S)
    assert len(np.unique(sc)) == SENT
    assert int(sc.max()).bit_length() + 32 <= 55
    for s in range(S):
        assert (np.diff(sc[s::S]) > 0).all()
    assert (SENT - 1) // S < (1 << qbits)


def _spec(n_aggs: int) -> sl.SessionSpec:
    return sl.SessionSpec(aggs=tuple(
        AggSpec(AggKind.SUM, f"s{i}", input=Col(f"v{i}"))
        for i in range(n_aggs)))


def test_one_card_takes_every_shard_in_one_table():
    devs = pl.key_shard_devices(make_mesh(1, 4, devices=["cpu"]))
    assert pl.session_groups(devs, 1) == [(torch.device("cpu"),
                                           [0, 1, 2, 3])]
    assert pl.session_groups(devs, 64) == [(torch.device("cpu"),
                                            [0, 1, 2, 3])]


def test_a_mesh_wrapped_over_two_cards_gives_one_table_a_card():
    a, b = torch.device("cpu", 0), torch.device("cpu", 1)
    devs = pl.key_shard_devices(make_mesh(1, 4, devices=[a, b]))
    assert pl.session_groups(devs, 3) == [(a, [0, 2]), (b, [1, 3])]
    devs = pl.key_shard_devices(make_mesh(2, 3, devices=[a, b]))
    assert devs == [a, b, a]
    assert pl.session_groups(devs, 3) == [(a, [0, 2]), (b, [1])]


def test_a_table_past_the_parameters_splits():
    """64 planes take 14 shards a launch (903 pointer sets), few planes
    16 (the shard cap); every shard launches once."""
    devs = [torch.device("cpu")] * 40
    g64 = pl.session_groups(devs, 64)
    assert [len(ks) for _d, ks in g64] == [14, 14, 12]
    assert sum((ks for _d, ks in g64), []) == list(range(40))
    assert [len(ks) for _d, ks in pl.session_groups(devs, 2)] == [16, 16, 8]
    assert [len(ks) for _d, ks in pl.session_groups(devs[:16], 56)] == [16]
    assert [len(ks) for _d, ks in pl.session_groups(devs[:16], 57)] == \
        [15, 1]
    # the table and the kernels' other parameters (a scratch of 17 words
    # and two ints) within Hopper's 32,764 bytes, the table nearly filling
    room = 32764 - 17 * 8 - 16
    assert room - 6 * 32 < ctypes.sizeof(kb.SessGroupArgs) <= room


def test_group_args_name_each_shards_planes(monkeypatch):
    """The table a launch takes: each shard's arena pointers in its
    place, the owner table naming the places, one description a plane
    (the spec's kinds and widths); a table past one launch is refused.
    Built here over CPU tensors (the binding's pointer check, which
    wants CUDA tensors, replaced by data_ptr)."""
    monkeypatch.setattr(kb, "ptr", lambda t: t.data_ptr())
    S, cap, shards = 4, 8, [1, 3]
    arenas = [sl.init_session_arena(TSPEC, cap, "cpu") for _ in range(S)]
    outs = [sl.init_session_arena(TSPEC, cap, "cpu") for _ in range(S)]
    a = sl._group_args(TSPEC, arenas, outs, shards, S, 5, kb.SESS_RECORD,
                       GAP, -7, 3)
    assert (a.cap, a.nb, a.n_shards, a.n_group, a.qbits) == \
        (cap, 5, S, 2, sl.session_qbits(S))
    assert (a.gap, a.close_cut, a.delta) == (GAP, -7, 3)
    assert list(a.pos[:S]) == [-1, 0, -1, 1]
    assert set(a.pos[S:]) == {-1}
    owners = sl._owners(TSPEC)
    assert a.n_planes == len(owners) == sl.n_planes(TSPEC)
    for q, (_i, _n, agg) in enumerate(owners):
        assert a.d[q].kind == sl._KERNEL_KIND[agg.kind]
        assert a.d[q].width == sl._plane_width(TSPEC, agg)
    for g, s in enumerate(shards):
        assert a.sh[g].code == arenas[s]["code"].data_ptr()
        assert a.sh[g].out_t1 == outs[s]["t1"].data_ptr()
        for q, (_i, name, agg) in enumerate(owners):
            pp = a.pp[g * a.n_planes + q]
            assert pp.src == arenas[s][name].data_ptr()
            assert pp.out == outs[s][name].data_ptr()
            if agg.kind == AggKind.AVG:
                assert pp.out_n == outs[s][name + "_n"].data_ptr()
            else:
                assert pp.out_n is None
    many = _spec(64)
    assert sl.n_planes(many) == 64
    ar = [sl.init_session_arena(many, 1, "cpu") for _ in range(15)]
    with pytest.raises(ValueError, match="does not fit a launch"):
        sl._group_args(many, ar, ar, list(range(15)), 15, 0,
                       kb.SESS_RECORD, GAP, 0, 0)
    sl._group_args(many, ar, ar, list(range(14)), 15, 0, kb.SESS_RECORD,
                   GAP, 0, 0)


# ---- ties of (code, start) at the int32 wrap ------------------------------
#
# The reference sorts the chain entries by (code, start, end). Where a
# running end lies within the gap of 2^31 - 1, its end + gap wraps in the
# break test, and which of two entries with equal (code, start) comes
# first decides the chains. The plain chain assignment, and with it the
# single-card step and merge, take equal (code, start) by end as the
# reference does, in either input order.

T_WRAP = 2**31 - 101
# (code, start, end) of the entries; "three": the chains [0, 0, 1]
TIES = {
    "three": ([5, 5, 5], [T_WRAP - 200, T_WRAP - 200, T_WRAP - 60],
              [T_WRAP - 10, T_WRAP - 190, T_WRAP - 60]),
}


def _tie_case(name: str):
    """(code, start, end) int32 arrays: TIES[name], or for "many" a
    random table near the wrap with runs of equal (code, start), ends
    before their starts (wrapped) and ends whose + gap wraps."""
    if name in TIES:
        return tuple(np.array(x, np.int64).astype(np.int32)
                     for x in TIES[name])
    rng = np.random.default_rng(17)
    m = 120
    code = rng.integers(0, 4, m).astype(np.int32)
    start = _wrap32(T_WRAP + rng.integers(-30, -5, m) * 10)
    end = _wrap32(start.astype(np.int64)
                  + rng.choice([0, 0, 10, 140, 190, 400], m))
    return code, start, end


def _ordered(x, order: str):
    return x[::-1].copy() if order == "reversed" else x


@pytest.mark.parametrize("order", ["given", "reversed"])
@pytest.mark.parametrize("case", ["three", "many"])
def test_tied_starts_at_the_wrap_take_the_references_chains(case, order):
    """chain_slots against the reference's _session_chain_slots."""
    code, start, end = (_ordered(x, order) for x in _tie_case(case))
    want = np.asarray(JL._session_chain_slots(
        jnp.asarray(code), jnp.asarray(start), jnp.asarray(end),
        np.int32(GAP), len(code)))
    got = sl.chain_slots(torch.from_numpy(code), torch.from_numpy(start),
                         torch.from_numpy(end), GAP, len(code)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "three":
        assert list(got) == ([0, 0, 1] if order == "given" else [1, 0, 0])
    else:   # equal (code, start) do meet, and the wrap changes chains
        key = code.astype(np.int64) << 32 | (start.astype(np.int64)
                                             + 2**31)
        assert len(np.unique(key)) < len(key)
        assert (end.astype(np.int64) + GAP > 2**31 - 1).any()


def _tie_arena(code, start, end, rng):
    """The reference's arena holding the entries in its first slots, with
    integral plane values (so every sum is exact)."""
    from test_torch_session_lattice import CAP, JSPEC

    a = JL.session_plane_np(JSPEC, CAP)
    n = len(code)
    a["code"][:n], a["t0"][:n], a["t1"][:n] = code, start, end
    for name, agg in zip(JL.session_plane_names(JSPEC), JSPEC.aggs):
        p = a[name]
        if p.dtype == np.int8 or p.ndim > 1:
            p[:n] = rng.integers(0, 3, p[:n].shape)
        else:
            p[:n] = rng.integers(1, 9, n)
            if name + "_n" in a:
                a[name + "_n"][:n] = rng.integers(1, 9, n)
    return a


@pytest.mark.parametrize("order", ["given", "reversed"])
@pytest.mark.parametrize("case", ["three", "many"])
@pytest.mark.parametrize("program", ["step", "merge"])
def test_tied_starts_at_the_wrap_in_the_step_and_merge(program, case,
                                                       order):
    """The single-card session step (B11) and merge (B12), plain on the
    CPU, against the reference's session_step_kernel and
    session_merge_kernel: the tied entries are arena rows, and the batch
    repeats their starts (records) or the entries themselves
    (segments)."""
    import test_torch_session_lattice as tsl

    rng = np.random.default_rng(len(case) + 3 * len(order))
    code, start, end = (_ordered(x, order) for x in _tie_case(case))
    arena = _tie_arena(code, start, end, rng)
    close_cut = -(1 << 30)
    if program == "step":
        n = len(code)
        ts = start.astype(np.int64)
        masks = [rng.random(n) < 0.1 for a in tsl._aggs(tsl.TM)
                 if a.input is not None]
        packed = JL.pack_batch_host(
            n, n, code, ts, np.ones(n, bool),
            {"v": rng.integers(-9, 9, n).astype(np.float32),
             "w": rng.integers(-9, 9, n).astype(np.int32),
             "b": rng.random(n) < 0.5}, masks, tsl.LAYOUT)
        step = JL.session_step_kernel(tsl.JSPEC, tsl.JSCHEMA, tsl.LAYOUT,
                                      tsl.CAP, n)
        want = {k: np.array(v) for k, v in step(
            {k: jnp.asarray(v) for k, v in arena.items()},
            jnp.asarray(packed), np.int32(GAP), np.int32(close_cut),
            np.int32(0)).items()}
        out = sl.init_session_arena(TSPEC, tsl.CAP, "cpu")
        p = torch.from_numpy(packed.copy())
        sl.session_step(TSPEC, {k: torch.from_numpy(v.copy())
                                for k, v in arena.items()}, out, p,
                        sl.session_inputs(TSPEC, tsl.LAYOUT, p,
                                          sl.session_programs(
                                              TSPEC, tsl.TSCHEMA)),
                        GAP, close_cut, 0)
        got = {k: v.numpy() for k, v in out.items()}
    else:
        seg = _tie_arena(code, start, end, rng)
        seg = {k: v[:len(code)].copy() for k, v in seg.items()}
        merge = JL.session_merge_kernel(tsl.JSPEC, tsl.CAP, len(code))
        want = {k: np.asarray(v) for k, v in merge(
            {k: jnp.asarray(v) for k, v in arena.items()},
            {k: jnp.asarray(v) for k, v in seg.items()}, np.int32(GAP),
            np.int32(close_cut), np.int32(0)).items()}
        out = sl.init_session_arena(TSPEC, tsl.CAP, "cpu")
        sl.session_merge(TSPEC, {k: torch.from_numpy(v.copy())
                                 for k, v in arena.items()}, out,
                         {k: torch.from_numpy(v) for k, v in seg.items()},
                         GAP, close_cut, 0)
        got = {k: v.numpy() for k, v in out.items()}
    tsl._assert_arenas(got, want, True)
    assert (want["code"] < SENT).sum() > 1
