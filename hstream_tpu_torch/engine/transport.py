"""Bit-packed columnar host->device transport (v3): a copy of the encoder
in hstream_tpu/engine/transport.py, and the decode as a Hopper kernel.

The encoder (BitpackTransport) must give byte-identical (combo, bases,
words) for the same input, so its code is the reference's, unchanged:
the host CPU decides encodings, the native codec (cpp/encode.cpp) packs.

Stream encodings:

  bp      unsigned bit-pack of (v - base) at `bits` bits per value,
          contiguous across word boundaries; bits=0 encodes a constant
          column in zero words
  bpd     delta pack for NONDECREASING streams (timestamps): packs the
          first differences, the device restores them with a prefix sum
  bool1   bools / null bitmaps at one bit per value
  dec     decimal floats: round(v*scale) quantization, then bp of
          (q - qmin); encodes iff the exact f32 round-trip
          decode(encode(v)) == v holds elementwise; the device decode is
          (base + u) * (1/scale), a single IEEE multiply
  raw32   f32 bitcast or i32, the lossless fallback

`decode_batch` is the wrapper of the wire-decode kernel
(engine/kernels/csrc/decode.cu) for words on the card, and of its plain
PyTorch version `decode_batch_ref` for words on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np
import torch

from hstream_tpu_torch.engine.kernels import binding as kb

ENC_BP = "bp"
ENC_BPD = "bpd"
ENC_BOOL = "bool1"
ENC_DEC = "dec"
ENC_RAW_F32 = "rawf"
ENC_RAW_I32 = "rawi"

DEC_SCALES = (1, 10, 100)  # fixed-point scales tried for float columns
DEC_MAX_Q = 1 << 30        # |q| bound: base+u must stay in int32
DEC_MAX_BITS = 24          # wider ranges fall back to raw32

# only streams known to be time-ordered attempt delta packing (bounded
# combo churn: everything else would demote on the first unsorted batch)
_DELTA_STREAMS = frozenset({"__dt"})


@dataclass(frozen=True)
class StreamPlan:
    """Encoding of one logical stream."""

    name: str          # "__kid", "__dt", "__valid", or a column name
    enc: str
    scale: int = 0     # ENC_DEC only
    bits: int = 0      # bp/bpd/dec width (bool1 is implicitly 1)

    def words(self, cap: int) -> int:
        if self.enc in (ENC_RAW_F32, ENC_RAW_I32):
            return cap
        b = 1 if self.enc == ENC_BOOL else self.bits
        # +1 pad word so the device's two-word gather never reads OOB
        return (cap * b + 31) // 32 + 1


Combo = tuple[StreamPlan, ...]


def wire_bytes(combo: Combo, cap: int) -> int:
    return 4 * sum(p.words(cap) for p in combo)


# quantized width ladder: widths only take these values, so a stream
# whose range creeps up recompiles the fused decode+aggregate step at
# most len(ladder) times, not once per bit (recompiles are seconds)
_BIT_LADDER = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 28, 32)


def _bits_for(hi: int) -> int:
    """Smallest ladder width holding values in [0, hi]."""
    need = int(hi).bit_length()
    for b in _BIT_LADDER:
        if b >= need:
            return b
    return 32


def _bitpack(vals: np.ndarray, bits: int, cap: int) -> np.ndarray:
    """Pack uint values (< 2**bits) at `bits` bits each into uint32
    words (+1 pad). Vectorized: values are laid out in blocks of 32 —
    a block spans exactly `bits` words, so per-lane shifts/offsets are
    compile-time constants and the pack is 32 vectorized ORs."""
    nw = (cap * bits + 31) // 32 + 1
    n = len(vals)
    if bits == 0 or n == 0:
        return np.zeros(nw, np.uint32)
    if bits == 32:
        out = np.zeros(nw, np.uint32)
        out[:n] = vals.astype(np.uint32)
        return out
    q = -(-n // 32)  # blocks
    v = np.zeros(q * 32, np.uint64)
    v[:n] = vals.astype(np.uint64)
    # transposed [32, q] layout: lane r is a CONTIGUOUS row, so the 32
    # shift/or ops below stream through memory instead of striding.
    # lane r lands in in-block word (r*bits)>>5 <= bits-1, so a block's
    # cells never spill past its own `bits` words; the sub-word carry
    # into the next 32-bit word is handled by the u64 lo/hi fold below.
    vt = np.ascontiguousarray(v.reshape(q, 32).T)
    buft = np.zeros((bits, q), np.uint64)
    for r in range(32):
        dr = (r * bits) >> 5
        sr = (r * bits) & 31
        buft[dr] |= vt[r] << np.uint64(sr)
    cells = np.zeros(q * bits + 1, np.uint64)
    cells[: q * bits] = buft.T.reshape(q * bits)
    out = np.zeros(nw, np.uint32)
    m = min(nw, len(cells))
    out[:m] = (cells[:m] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[1:m] |= (cells[: m - 1] >> np.uint64(32)).astype(np.uint32)
    return out


_M32 = 0xFFFFFFFF


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 -> int32 (the reference's wrap)."""
    x = x & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _bp_decode_ref(words64: torch.Tensor, bits: int, cap: int
                   ) -> torch.Tensor:
    """Unpack `cap` uint values of `bits` bits -> int64 [cap]. Value i
    starts at bit i*bits and may straddle two words (the +1 pad word
    keeps the second read in bounds)."""
    if bits == 0:
        return torch.zeros(cap, dtype=torch.int64, device=words64.device)
    pos = torch.arange(cap, dtype=torch.int64, device=words64.device) * bits
    w0 = pos >> 5
    sh = pos & 31
    lo = words64[w0] >> sh
    hi = torch.where(sh == 0, 0, (words64[w0 + 1] << (32 - sh)) & _M32)
    return (lo | hi) & ((1 << bits) - 1)


def _unpack_stream_ref(plan: StreamPlan, words: torch.Tensor, cap: int,
                       base: int) -> torch.Tensor:
    """Plain decode of one stream (transport.py:167-194 in the
    reference) -> [cap] tensor."""
    if plan.enc == ENC_RAW_F32:
        return words[:cap].view(torch.float32).clone()
    if plan.enc == ENC_RAW_I32:
        return words[:cap].clone()
    words64 = words.to(torch.int64) & _M32
    if plan.enc == ENC_BOOL:
        return _bp_decode_ref(words64, 1, cap) != 0
    u = _bp_decode_ref(words64, plan.bits, cap)
    if plan.enc == ENC_BPD:
        return _to_i32(base + torch.cumsum(u, 0))
    v = _to_i32(base + u)
    if plan.enc == ENC_DEC:
        # single IEEE multiply, bit-identical to the host verifier
        inv = torch.tensor(np.float32(1.0 / plan.scale), device=v.device)
        return v.to(torch.float32) * inv
    return v


def decode_batch_ref(words: torch.Tensor, combo: Combo, cap: int, n,
                     bases) -> tuple:
    """Plain PyTorch decode: ONE int32 buffer (the uint32 wire words'
    bits) -> (key_ids i32, ts_rel i32, valid bool, {name: column}).
    Rows past n are invalid, and so is a row whose __valid bit is 0."""
    off = 0
    streams: dict[str, torch.Tensor] = {}
    for i, plan in enumerate(combo):
        w = plan.words(cap)
        streams[plan.name] = _unpack_stream_ref(plan, words[off:off + w],
                                                cap, int(bases[i]))
        off += w
    key_ids = streams.pop("__kid")
    ts = streams.pop("__dt")
    valid = torch.arange(cap, device=words.device) < int(n)
    if "__valid" in streams:
        valid = valid & streams.pop("__valid")
    return key_ids, ts, valid, streams


H100_SMS = 132
DECODE_TILE = kb.DECODE_THREADS * kb.DECODE_PER  # values a tile
DECODE_BLOCKS_PER_SM = 4   # resident blocks of 256 threads an SM


class DecodePlan(NamedTuple):
    blocks: int       # grid size
    tiles: int        # tiles of DECODE_TILE values a block
    delta_warps: int  # the warps a block gives the delta stream


def decode_plan(cap: int, n_sms: int = H100_SMS, columns: int = 2
                ) -> DecodePlan:
    """The wire-decode kernel's grid for a batch of `cap` values: at most
    DECODE_BLOCKS_PER_SM blocks an SM, each taking the same number of
    whole tiles in a row (the last block fewer), so the grid is one wave
    and the delta stream's look-back spans at most that many blocks. With
    a delta stream, its warps (its sum, look-back and scan cost about as
    much as two or three other columns) are four of a block's eight
    where the other warps decode at most two columns besides valid,
    else two."""
    tiles = max(1, -(-cap // DECODE_TILE))
    per = -(-tiles // (n_sms * DECODE_BLOCKS_PER_SM))
    return DecodePlan(-(-tiles // per), per, 4 if columns <= 2 else 2)


_status: dict[tuple, list] = {}
_status_mutex = threading.Lock()


def _decode_status(device: torch.device, stream: int, blocks: int
                   ) -> tuple[torch.Tensor, int]:
    """(the delta stream's look-back words for launches on one device and
    stream, int64 [>= blocks], zeroed when made; this launch's epoch).
    The kernel tags each word with its launch's epoch and reads only its
    own, so the words are never cleared; when the 32-bit epoch would
    wrap, the buffer is zeroed and the count starts again."""
    with _status_mutex:
        entry = _status.get((device, stream))
        if entry is None or entry[0].numel() < blocks:
            entry = _status[(device, stream)] = [
                torch.zeros(blocks, dtype=torch.int64, device=device), 0]
        entry[1] += 1
        if entry[1] >= 1 << 32:
            entry[0].zero_()
            entry[1] = 1
        return entry[0], entry[1]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count (the kernels' plans size their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_batch(words: torch.Tensor, combo: Combo, cap: int, n,
                 bases) -> tuple:
    """Decode one wire buffer into device columns: the wire-decode
    kernel for words on the card (one launch, decode_plan's grid),
    decode_batch_ref for words on the CPU. `bases` are host ints (they
    ride in the kernel's parameters)."""
    if words.device.type == "cpu":
        return decode_batch_ref(words, combo, cap, n, bases)
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError("wire words must be a 1-D int32 tensor")
    if len(combo) > kb.MAX_STREAMS:
        raise ValueError(f"{len(combo)} wire streams > {kb.MAX_STREAMS}")
    if words.numel() != sum(p.words(cap) for p in combo):
        raise ValueError("wire buffer length does not match its combo")
    dev = words.device
    args = kb.DecodeArgs()
    args.words = kb.ptr(words)
    args.cap, args.n, args.n_streams = cap, int(n), len(combo)
    args.valid_stream = args.delta_stream = -1
    streams: dict[str, torch.Tensor] = {}
    off = 0
    for i, plan in enumerate(combo):
        st = args.s[i]
        st.word_off, st.enc = off, kb.ENC_CODES[plan.enc]
        st.bits = 1 if plan.enc == ENC_BOOL else plan.bits
        st.base = int(bases[i])
        st.inv_scale = float(np.float32(1.0 / plan.scale)) \
            if plan.enc == ENC_DEC else 0.0
        off += plan.words(cap)
        if plan.name == "__valid":
            args.valid_stream = i
            continue
        if plan.enc == ENC_BPD:
            if args.delta_stream >= 0:
                raise ValueError("more than one delta-packed stream")
            args.delta_stream = i
        dtype = (torch.float32 if plan.enc in (ENC_RAW_F32, ENC_DEC)
                 else torch.bool if plan.enc == ENC_BOOL else torch.int32)
        out = torch.empty(cap, dtype=dtype, device=dev)
        streams[plan.name] = out
        st.out = out.data_ptr()
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    args.valid_out = valid.data_ptr()
    args.blocks, args.tiles, args.delta_warps = decode_plan(
        cap, sm_count(dev), len(streams) - (args.delta_stream >= 0))
    stream = kb.stream_of(words)
    if args.delta_stream >= 0:
        status, args.epoch = _decode_status(dev, stream, args.blocks)
        args.status = status.data_ptr()
    kb.check(kb.lib().hs_decode(ctypes.byref(args), stream), "wire_decode")
    decode_batch.launches += 1
    key_ids = streams.pop("__kid")
    ts = streams.pop("__dt")
    return key_ids, ts, valid, streams


decode_batch.launches = 0  # wrapper calls that launched the kernel


def _lib():
    from hstream_tpu_torch.engine import codec_native

    return codec_native.load()


def _ptr(arr: np.ndarray, ctype):
    import ctypes as C

    return arr.ctypes.data_as(C.POINTER(ctype))


def _native_minmax(lib, v: np.ndarray) -> tuple[int, int]:
    import ctypes as C

    lo = C.c_int64()
    hi = C.c_int64()
    if v.dtype == np.int32:
        lib.enc_minmax_i32(_ptr(v, C.c_int32), len(v),
                           C.byref(lo), C.byref(hi))
    else:
        lib.enc_minmax_i64(_ptr(v, C.c_int64), len(v),
                           C.byref(lo), C.byref(hi))
    return lo.value, hi.value


class BitpackTransport:
    """Per-query encoder with sticky adaptive per-column encoding.

    Policies are monotone (bits only widen; bpd -> bp and dec -> raw32
    demote at most once) so the set of combos — and therefore jit
    recompiles — is bounded over a query's lifetime. The per-element
    passes (stats, quantize, pack) run in the native codec kernels
    (cpp/encode.cpp) when buildable, with pure-numpy fallbacks.

    Thread-safety: encode() may be called CONCURRENTLY from several
    pipeline encode workers without a lock. Each call's returned
    (combo, bases, words) triple is built only from call-local state,
    so every batch is self-describing regardless of interleaving; the
    adaptive dicts/sets (_bits, _dec_scale, _demoted, ...) are touched
    only via single GIL-atomic get/set/add ops, and a racy lost update
    merely delays a sticky widening/demotion by one batch (costing at
    most one extra jit specialization later, never a wrong decode).
    """

    def __init__(self) -> None:
        self._dec_scale: dict[str, int] = {}   # col -> last good scale
        self._demoted: set[str] = set()        # dec failed -> raw32 forever
        self._raw_int: set[str] = set()        # int stream too wide -> raw32
        self._bits: dict[str, int] = {}        # stream -> widest bits so far
        self._no_delta: set[str] = set()       # bpd failed -> bp forever

    def _widen(self, name: str, need: int) -> int:
        bits = max(self._bits.get(name, 0), need)
        self._bits[name] = bits
        return bits

    def _plan_uint(self, name: str, vals: np.ndarray
                   ) -> tuple[StreamPlan, int, np.ndarray]:
        """(plan, base, payload) for an integer stream. The payload is
        the RAW contiguous array; _pack_into applies base/diff."""
        lib = _lib()
        v = np.ascontiguousarray(vals)
        if v.dtype not in (np.int32, np.int64):
            v = v.astype(np.int64)
        if len(v) == 0:
            return StreamPlan(name, ENC_BP, bits=0), 0, v
        if name in _DELTA_STREAMS and name not in self._no_delta:
            v64 = v if v.dtype == np.int64 else v.astype(np.int64)
            if lib is not None:
                import ctypes as C

                dmax = C.c_int64()
                ok = lib.enc_diff_stats_i64(_ptr(v64, C.c_int64),
                                            len(v64), C.byref(dmax))
                ok, dmax = bool(ok), dmax.value
            else:
                d = np.diff(v64)
                ok = len(d) == 0 or d.min() >= 0
                dmax = int(d.max()) if ok and len(d) else 0
            if ok:
                bits = self._widen(name + "#d", _bits_for(dmax))
                return (StreamPlan(name, ENC_BPD, bits=bits),
                        int(v64[0]), v64)
            self._no_delta.add(name)
        if lib is not None:
            lo, hi = _native_minmax(lib, v)
        else:
            lo, hi = int(v.min()), int(v.max())
        if name in self._raw_int or lo < -(1 << 30) or hi > (1 << 30):
            self._raw_int.add(name)
            return StreamPlan(name, ENC_RAW_I32), 0, v
        bits = self._widen(name, _bits_for(hi - lo))
        return StreamPlan(name, ENC_BP, bits=bits), lo, v

    def _plan_float(self, name: str, vals: np.ndarray
                    ) -> tuple[StreamPlan, int, np.ndarray]:
        """(plan, base, payload): payload is the quantized int32 array
        for dec, or the raw floats for raw32."""
        if name in self._demoted:
            return StreamPlan(name, ENC_RAW_F32), 0, vals
        lib = _lib()
        # single atomic read: a concurrent encode worker demoting this
        # column pops the scale between a `in` check and a subscript
        sticky_scale = self._dec_scale.get(name)
        scales = [sticky_scale] if sticky_scale is not None \
            else list(DEC_SCALES)
        # all-f32 quantization; any rounding discrepancy vs a wider path
        # is caught by the round-trip verification, the actual guarantee
        v32 = np.ascontiguousarray(vals, np.float32)
        for s in scales:
            if lib is not None:
                import ctypes as C

                q = np.empty(len(v32), np.int32)
                qlo = C.c_int64()
                qhi = C.c_int64()
                ok = lib.enc_quantize_f32(
                    _ptr(v32, C.c_float), len(v32), C.c_float(s),
                    C.c_float(np.float32(1.0 / s)), DEC_MAX_Q,
                    _ptr(q, C.c_int32), C.byref(qlo), C.byref(qhi))
                if not ok:
                    continue
                qmin, qmax = qlo.value, qhi.value
            else:
                qf = np.rint(v32 * np.float32(s))
                with np.errstate(invalid="ignore"):
                    if not (np.abs(qf) <= DEC_MAX_Q).all():
                        continue
                q = qf.astype(np.int32)
                # mirrors the device decode formula exactly
                if not (q.astype(np.float32) * np.float32(1.0 / s)
                        == v32).all():
                    continue
                qmin, qmax = int(q.min()), int(q.max())
            span_bits = _bits_for(qmax - qmin)
            if span_bits > DEC_MAX_BITS:
                continue
            self._dec_scale[name] = s
            bits = self._widen(name, span_bits)
            return StreamPlan(name, ENC_DEC, scale=s, bits=bits), qmin, q
        self._demoted.add(name)
        self._dec_scale.pop(name, None)
        return StreamPlan(name, ENC_RAW_F32), 0, vals

    def _pack_into(self, plan: StreamPlan, base: int, payload: np.ndarray,
                   out: np.ndarray, cap: int) -> None:
        """Pack one stream into its slice of the words buffer."""
        n = len(payload)
        if plan.enc == ENC_RAW_F32:
            buf = np.zeros(cap, np.float32)
            buf[:n] = payload
            out[:] = buf.view(np.uint32)
            return
        if plan.enc == ENC_RAW_I32:
            buf = np.zeros(cap, np.int32)
            buf[:n] = payload
            out[:] = buf.view(np.uint32)
            return
        lib = _lib()
        if lib is not None:
            import ctypes as C

            p_out = _ptr(out, C.c_uint32)
            if plan.enc == ENC_BOOL:
                b = np.ascontiguousarray(payload, np.uint8)
                lib.enc_pack_bool(_ptr(b, C.c_uint8), n, p_out, len(out))
            elif plan.enc == ENC_BPD:
                lib.enc_pack_diff_i64(_ptr(payload, C.c_int64), n,
                                      plan.bits, p_out, len(out))
            elif payload.dtype == np.int32:
                lib.enc_pack_i32(_ptr(payload, C.c_int32), n, base,
                                 plan.bits, p_out, len(out))
            else:
                lib.enc_pack_i64(_ptr(payload, C.c_int64), n, base,
                                 plan.bits, p_out, len(out))
            return
        if plan.enc == ENC_BOOL:
            out[:] = _bitpack(np.asarray(payload, np.uint8), 1, cap)
        elif plan.enc == ENC_BPD:
            d = np.diff(payload, prepend=payload[0] if n else 0)
            out[:] = _bitpack(d, plan.bits, cap)
        else:
            out[:] = _bitpack(
                np.asarray(payload, np.int64) - base, plan.bits, cap)

    def encode(self, cap: int, n: int, key_ids: np.ndarray,
               ts_rel: np.ndarray,
               cols: Mapping[str, np.ndarray],
               layout: tuple[tuple[str, str], ...],
               valid: np.ndarray | None = None,
               null_streams: Mapping[str, np.ndarray] | None = None,
               ) -> tuple[Combo, np.ndarray, np.ndarray]:
        """Encode one micro-batch -> (combo, bases i32, uint32 words).

        `layout` is the (name, "f32"|"i32"|"bool") column layout from the
        executor. `null_streams` maps __null_a{i} flag-stream names to
        bool arrays (each becomes a 1-bit stream; absent means no nulls).
        """
        plans: list[StreamPlan] = []
        bases: list[int] = []
        payloads: list[np.ndarray] = []

        def add(plan: StreamPlan, base: int, payload: np.ndarray) -> None:
            plans.append(plan)
            bases.append(base)
            payloads.append(payload)

        add(*self._plan_uint("__kid", key_ids[:n]))
        add(*self._plan_uint("__dt", np.asarray(ts_rel[:n], np.int64)))
        if valid is not None:
            add(StreamPlan("__valid", ENC_BOOL), 0,
                np.asarray(valid[:n], np.bool_))

        for name, tag in layout:
            vals = np.asarray(cols[name])[:n]
            if tag == "f32":
                add(*self._plan_float(name, vals))
            elif tag == "bool":
                add(StreamPlan(name, ENC_BOOL), 0,
                    np.asarray(vals, np.bool_))
            else:
                add(*self._plan_uint(name, vals))
        for name, mask in (null_streams or {}).items():
            add(StreamPlan(name, ENC_BOOL), 0,
                np.asarray(mask[:n], np.bool_))

        combo = tuple(plans)
        total = sum(p.words(cap) for p in combo)
        words = np.empty(total, np.uint32)
        off = 0
        for plan, base, payload in zip(combo, bases, payloads):
            w = plan.words(cap)
            self._pack_into(plan, base, payload, words[off:off + w], cap)
            off += w
        return combo, np.asarray(bases, np.int32), words
