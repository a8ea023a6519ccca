"""Public entry points of the Anderson-step kernels, batched over clients.

Counterpart of repro/kernels/anderson/ops.py::flat_gram/flat_update: one
call serves all K clients, so each pass is ONE launch per round. A vector
shared by every client (the server's w^t and ∇f(w^t)) is passed as [d]
and read with a client stride of 0 — it is never copied K times.
``aa_step`` is everything after the Gram pass (the screen, the eigen-solve,
the stats and the update) in one launch; the main path runs ``flat_gram``
then ``aa_step``. ``flat_update`` stands alone.

Dispatch is by the tensors' device only: CPU tensors run the plain version
(ref.py); CUDA tensors launch csrc/gram.cu / csrc/update.cu or raise;
tensors on the meta device (shapes only, launch/dryrun.py) run the plain
version with no host read. No
padding: the kernels mask their own edges. The Gram pass has two designs,
chosen from the shape (``gram_parts``): one block a client, or, for few
clients of a wide d, each client's d split over the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.anderson.ref import (aa_step_ref, acc_dtype, gram_ref,
                                              update_ref)

#: history length the Gram kernel's pair table and the AA step's shared
#: memory hold (csrc/gram.cu, csrc/update.cu)
MAX_HISTORY = 64
#: the split Gram design's largest history: its m(m+1)/2 + m sums live in
#: registers (csrc/gram.cu kSplitMaxHistory)
SPLIT_MAX_HISTORY = 8
#: columns from which a client's Gram pass may be split over the card
SPLIT_MIN_COLUMNS = 1 << 16
#: columns a part of the split design takes at least
SPLIT_PART_COLUMNS = 8192
#: columns an update block of the AA step takes at least (csrc/update.cu
#: streams them 256 at a time); a client of at most this many columns runs
#: in one block
STEP_COLUMNS = 2048


def _client_stride(v: torch.Tensor, K: int, d: int) -> int:
    """Element stride between clients of a [d] (shared: 0) or [K, d] vector."""
    if v.shape == (d,):
        return 0
    if v.shape == (K, d):
        return d
    raise ValueError(f"expected shape ({d},) or ({K}, {d}), got {tuple(v.shape)}")


def gram_parts(K: int, m: int, d: int, sms: int) -> int:
    """The Gram pass's design for a shape: 0 for the block design (one
    block a client: many clients or a narrow d), else the number of parts
    of d each client is split into (few clients, a wide d, m <= 8): about
    eight blocks an SM over the card, each part at least
    SPLIT_PART_COLUMNS wide."""
    if m > SPLIT_MAX_HISTORY or d < SPLIT_MIN_COLUMNS or K >= sms:
        return 0
    return _split_parts(K, d, sms)


def _split_parts(K: int, d: int, sms: int) -> int:
    return max(1, min(-(-d // SPLIT_PART_COLUMNS), -(-8 * sms // K)))


def flat_gram(y: torch.Tensor, g: torch.Tensor, design: str | None = None):
    """One pass over Y: y [K, m, d], g [K, d] or [d] → (Y Yᵀ [K, m, m],
    Y g [K, m]) in the accumulation type (f64 for f64, else f32).
    ``design`` ("block" or "split") overrides ``gram_parts``' choice on
    the card. d may be 0 (zeros)."""
    if y.device.type in ("cpu", "meta"):
        return gram_ref(y, g)
    return _gram_cuda(y, g, design)


def _gram_cuda(y, g, design=None):
    """Launch csrc/gram.cu in the design ``gram_parts`` picks: one block per
    client, or each client's d split into parts over the card."""
    K, m, d = y.shape
    a = acc_dtype(y.dtype)
    y, g = y.to(a).contiguous(), g.to(a).contiguous()
    if m > MAX_HISTORY:
        raise ValueError(f"gram kernel: m={m} > {MAX_HISTORY} history columns")
    g_stride = _client_stride(g, K, d)
    dev = _build.check_cuda("gram", y, g)
    gram = torch.empty((K, m, m), dtype=a, device=dev)
    yg = torch.empty((K, m), dtype=a, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = gram_parts(K, m, d, sms)
    if design == "split":
        if m > SPLIT_MAX_HISTORY:
            raise ValueError(f"gram kernel: the split design takes m <= "
                             f"{SPLIT_MAX_HISTORY}, got {m}")
        parts = _split_parts(K, d, sms)
    elif design == "block":
        parts = 0
    elif design is not None:
        raise ValueError(f"gram kernel: unknown design {design!r}")
    with torch.cuda.device(dev):
        if parts:
            ws = torch.empty((K, parts, m * (m + 1) // 2 + m), dtype=a, device=dev)
            _build.launch("gram", "repro_gram_split", _build.DTYPE_CODE[a],
                          y.data_ptr(), g.data_ptr(), g_stride, gram.data_ptr(),
                          yg.data_ptr(), ws.data_ptr(), K, m, d, parts,
                          design="split")
        else:
            _build.launch("gram", "repro_gram", _build.DTYPE_CODE[a], y.data_ptr(),
                          g.data_ptr(), g_stride, gram.data_ptr(), yg.data_ptr(),
                          K, m, d, design="block")
    return gram, yg


def flat_update(w, g, s, y, gamma, eta: float, beta: float):
    """One pass over S and Y: w⁺ = w − ηg − β(Sᵀγ − ηYᵀγ) per client.

    w, g: [K, d] or [d]; s, y: [K, m, d]; gamma: [K, m]. Returns [K, d] in
    w.dtype."""
    if s.device.type in ("cpu", "meta"):
        return update_ref(w, g, s, y, gamma, eta, beta)
    return _update_cuda(w, g, s, y, gamma, eta, beta)


def _update_cuda(w, g, s, y, gamma, eta, beta):
    """Launch csrc/update.cu: a block per 256 columns of each client."""
    K, m, d = s.shape
    a = acc_dtype(s.dtype)
    if w.dtype != a:
        raise TypeError(f"update kernel: w is {w.dtype}, S/Y are {s.dtype}")
    w, g, s, y, gamma = (t.to(a).contiguous() for t in (w, g, s, y, gamma))
    if y.shape != (K, m, d) or gamma.shape != (K, m):
        raise ValueError(f"update kernel: shapes s {tuple(s.shape)}, "
                         f"y {tuple(y.shape)}, gamma {tuple(gamma.shape)}")
    w_stride, g_stride = _client_stride(w, K, d), _client_stride(g, K, d)
    dev = _build.check_cuda("update", w, g, s, y, gamma)
    out = torch.empty((K, d), dtype=a, device=dev)
    with torch.cuda.device(dev):
        _build.launch("update", "repro_update", _build.DTYPE_CODE[a],
                      w.data_ptr(), w_stride, g.data_ptr(), g_stride,
                      s.data_ptr(), y.data_ptr(), gamma.data_ptr(),
                      out.data_ptr(), K, m, d, float(eta), float(beta))
    return out


def aa_step_blocks(K: int, d: int, sms: int) -> int:
    """Blocks a client of the AA step (csrc/update.cu's grid x): 1 where d
    fits one block's share (the block solves, writes the stats and updates
    every column); else a stats block and enough update blocks to give the
    card about four a multiprocessor, each at least STEP_COLUMNS wide."""
    need = -(-d // STEP_COLUMNS)
    if need <= 1:
        return 1
    return min(need, max(1, 4 * sms // K)) + 1


def aa_step(w, g, s, y, gram, yg, eta: float, *, damping: float,
            tikhonov: float, filter_rtol: float, clip_rtol: float,
            g_norm2: torch.Tensor | None = None):
    """The AA step after the Gram pass (ref.py::aa_step_ref), all clients
    in one launch: w, g [d] (shared) or [K, d]; s, y [K, m, d]; gram
    [K, m, m] and yg [K, m] from ``flat_gram``; ``g_norm2`` [K], ‖g‖² for
    θ where the caller has it (a sharded step's sum over every rank's
    part), else summed by the kernel over g. Every tensor has one dtype,
    f32 or f64. Returns (w⁺ [K, d], Γ [K, m], θ, ‖Γ‖, cond [K], used,
    clipped [K] int64)."""
    K, m, d = s.shape
    given = () if g_norm2 is None else (g_norm2,)
    dtypes = {t.dtype for t in (w, g, s, y, gram, yg, *given)}
    if len(dtypes) != 1 or acc_dtype(s.dtype) != s.dtype:
        raise TypeError(f"aa_step: w, g, s, y, gram, yg must share one dtype, "
                        f"float32 or float64; got {sorted(map(str, dtypes))}")
    if (y.shape != (K, m, d) or gram.shape != (K, m, m) or yg.shape != (K, m)
            or any(t.shape != (K,) for t in given)):
        raise ValueError(f"aa_step: shapes s {tuple(s.shape)}, y "
                         f"{tuple(y.shape)}, gram {tuple(gram.shape)}, yg "
                         f"{tuple(yg.shape)}, g_norm2 "
                         f"{[tuple(t.shape) for t in given]}")
    w_stride, g_stride = _client_stride(w, K, d), _client_stride(g, K, d)
    kw = dict(damping=damping, tikhonov=tikhonov, filter_rtol=filter_rtol,
              clip_rtol=clip_rtol, g_norm2=g_norm2)
    if s.device.type == "meta":
        # no values: the eigen-solve runs all its sweeps instead of
        # reading on the host whether every client has stopped
        return aa_step_ref(w, g, s, y, gram, yg, eta, **kw, stop_early=False)
    if s.device.type == "cpu":
        return aa_step_ref(w, g, s, y, gram, yg, eta, **kw)
    if m > MAX_HISTORY:
        raise ValueError(f"aa_step kernel: m={m} > {MAX_HISTORY} history columns")
    dev = _build.check_cuda("aa_step", w, g, s, y, gram, yg, *given)
    gn2 = given[0].contiguous() if given else None
    a = s.dtype
    out = torch.empty((K, d), dtype=a, device=dev)
    gamma = torch.empty((K, m), dtype=a, device=dev)
    stats = torch.empty((3, K), dtype=a, device=dev)
    counts = torch.empty((2, K), dtype=torch.int64, device=dev)
    blocks = aa_step_blocks(K, d, torch.cuda.get_device_properties(dev)
                            .multi_processor_count)
    with torch.cuda.device(dev):
        _build.launch("aa_step", "repro_aa_step", _build.DTYPE_CODE[a],
                      w.data_ptr(), w_stride, g.data_ptr(), g_stride,
                      s.data_ptr(), y.data_ptr(), gram.data_ptr(), yg.data_ptr(),
                      out.data_ptr(), gamma.data_ptr(), stats.data_ptr(),
                      counts.data_ptr(), None if gn2 is None else gn2.data_ptr(),
                      K, m, d, blocks, float(eta),
                      float(damping), float(tikhonov), float(filter_rtol),
                      float(clip_rtol))
    return out, gamma, stats[0], stats[1], stats[2], counts[0], counts[1]
