"""Plain PyTorch versions of the Anderson-step kernels.

Counterparts of repro/kernels/anderson/ref.py::gram_ref/update_ref, batched
over a leading client axis K. Accumulation type (the port's rule, stated
in PERF.md): f32 for f32 inputs — exactly the TPU kernel — and f64 for f64
inputs, where the TPU kernel downcasts to f32. The CUDA kernels
(csrc/gram.cu, csrc/update.cu) follow the same rule.

``aa_step_ref`` is the whole AA step after the Gram pass (csrc/update.cu's
``repro_aa_step``), and ``jacobi_eigh_ref`` its eigen-solve. They follow the
kernel op for op: every product, sum, quotient and square root is one
IEEE-rounded torch op (the kernel uses the ``_rn`` intrinsics, so nothing
is contracted into an FMA), every sum runs in the kernel's order, and a
division is by a tensor (PyTorch's CUDA division by a Python number
multiplies by its reciprocal). Only ‖g‖² (a sum over d, for θ) is summed
in another order.
"""
from __future__ import annotations

import torch

#: cyclic Jacobi's sweep limit (csrc/update.cu kMaxSweeps)
MAX_SWEEPS = 30
#: the eigenvalue floor of the solve (a kept eigenvalue exceeds this share
#: of the largest, and the conditioning reported divides by at least it)
TINY = 1e-30


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type of the Anderson kernels for ``dtype`` inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def gram_ref(y: torch.Tensor, g: torch.Tensor):
    """y: [K, m, d]; g: [K, d] or [d] → (Y Yᵀ [K, m, m], Y g [K, m])."""
    a = acc_dtype(y.dtype)
    ya, ga = y.to(a), g.to(a).expand(y.shape[0], y.shape[2])
    return ya @ ya.transpose(-1, -2), (ya @ ga.unsqueeze(-1)).squeeze(-1)


def update_ref(w, g, s, y, gamma, eta: float, beta: float):
    """w⁺ = w − ηg − β(Sᵀγ − ηYᵀγ) per client.

    w, g: [K, d] or [d]; s, y: [K, m, d]; gamma: [K, m]. Returns [K, d] in
    w.dtype.
    """
    a = acc_dtype(s.dtype)
    wa, ga = w.to(a), g.to(a)
    gm = gamma.to(a).unsqueeze(-2)                     # [K, 1, m]
    s_g = (gm @ s.to(a)).squeeze(-2)                   # [K, d]
    y_g = (gm @ y.to(a)).squeeze(-2)
    out = wa - eta * ga - beta * (s_g - eta * y_g)
    return out.to(w.dtype)


def round_robin_pairs(n: int) -> list[tuple[list[int], list[int]]]:
    """The n − 1 rounds of the circle method over an even n indices: round r
    pairs (r, n − 1) and, for k = 1 .. n/2 − 1, (r + k, r − k) mod (n − 1),
    each as (p, q) with p < q. A round's pairs are disjoint; a sweep of all
    rounds meets every pair once (csrc/update.cu::round_pair)."""
    rounds = []
    for r in range(n - 1):
        ps, qs = [], []
        for k in range(n // 2):
            if k == 0:
                a, b = r, n - 1
            else:
                a, b = (r + k) % (n - 1), (r - k + n - 1) % (n - 1)
            ps.append(min(a, b))
            qs.append(max(a, b))
        rounds.append((ps, qs))
    return rounds


def _significant(apq, dp, dq, eps):
    """|a_pq| > eps·sqrt|a_pp|·sqrt|a_qq| (dp, dq: the square roots)."""
    return apq.abs() > (dp * eps) * dq


def _jacobi_round(A, V, p, q, active, eps):
    """One round of disjoint rotations on A [K, n, n] and V (see
    jacobi_eigh_ref). Each pair's 2×2 block of every pair of pairs is
    rotated in one fixed order — columns by the second pair, then rows by
    the first — and written to both triangles, so A stays exactly
    symmetric. A client that is not ``active`` does not rotate."""
    K, n, _ = A.shape
    h = n // 2
    dev = A.device
    one = torch.ones((), dtype=A.dtype, device=dev)
    ar = torch.arange(K, device=dev)[:, None]
    app, aqq, apq = A[ar, p, p], A[ar, q, q], A[ar, p, q]      # [K, h]
    rot = active[:, None] & _significant(apq, app.abs().sqrt(),
                                         aqq.abs().sqrt(), eps)
    theta = (aqq - app) / (apq * 2.0)       # masked below where rot is False
    tt = theta * theta
    den = theta.abs() + (tt + one).sqrt()
    t = torch.where(torch.isfinite(tt),
                    torch.where(theta >= 0, one, -one) / den, (one * 0.5) / theta)
    c = one / (t * t + one).sqrt()
    s = t * c
    t = torch.where(rot, t, 0.0)
    c = torch.where(rot, c, one)
    s = torch.where(rot, s, 0.0)

    perm = torch.stack([p, q], 1).reshape(-1)           # [p0, q0, p1, q1, ...]
    inv = torch.argsort(perm)
    X = A[:, perm][:, :, perm].reshape(K, h, 2, h, 2)
    c2, s2 = c[:, None, None, :], s[:, None, None, :]   # column pair
    x0, x1 = X[..., 0], X[..., 1]
    Y = torch.stack([c2 * x0 - s2 * x1, s2 * x0 + c2 * x1], -1)
    c1, s1 = c[:, :, None, None], s[:, :, None, None]   # row pair
    y0, y1 = Y[:, :, 0], Y[:, :, 1]
    Z = torch.stack([c1 * y0 - s1 * y1, s1 * y0 + c1 * y1], 2).reshape(K, n, n)
    blk = torch.arange(n, device=dev) // 2
    Z = torch.where(blk[:, None] < blk[None, :], Z, Z.transpose(1, 2))
    i0, i1 = (torch.arange(j, n, 2, device=dev) for j in (0, 1))
    tapq = t * apq
    Z[:, i0, i0] = app - tapq
    Z[:, i1, i1] = aqq + tapq
    Z[:, i0, i1] = Z[:, i1, i0] = torch.where(rot, 0.0, apq)
    A_new = Z[:, inv][:, :, inv]

    Vp = V[:, :, perm].reshape(K, n, h, 2)
    cv, sv = c[:, None, :], s[:, None, :]
    v0, v1 = Vp[..., 0], Vp[..., 1]
    V_new = torch.stack([cv * v0 - sv * v1, sv * v0 + cv * v1], -1).reshape(
        K, n, n)[:, :, inv]
    # a round none of whose pairs rotates changes nothing (as in the kernel)
    keep = rot.any(-1)[:, None, None]
    return torch.where(keep, A_new, A), torch.where(keep, V_new, V)


def jacobi_eigh_ref(a: torch.Tensor):
    """Cyclic Jacobi eigendecomposition of symmetric a [K, m, m] in its own
    dtype, as csrc/update.cu runs it. Returns (evals [K, m] — the diagonal,
    unsorted; evecs [K, m, m], column j for evals[:, j]; sweeps [K]).

    An odd m is padded with one zero row and column (its pairs never
    rotate). Each sweep runs the n − 1 rounds of ``round_robin_pairs``.
    Pair (p, q) rotates when |a_pq| > eps·sqrt|a_pp|·sqrt|a_qq| (eps the
    dtype's machine epsilon), by the stable angle tan φ = sgn θ / (|θ| +
    sqrt(θ² + 1)), θ = (a_qq − a_pp) / 2a_pq (1/2θ where θ² overflows).
    Stop rule: before each sweep, a client none of whose pairs would
    rotate stops (the off-diagonal of the diagonally scaled matrix is
    below eps, which keeps the small eigenvalues' relative accuracy);
    at most MAX_SWEEPS sweeps."""
    K, m, _ = a.shape
    n = m + (m & 1)
    eps = torch.finfo(a.dtype).eps
    A = torch.zeros((K, n, n), dtype=a.dtype, device=a.device)
    A[:, :m, :m] = a
    V = torch.eye(n, dtype=a.dtype, device=a.device).expand(K, n, n).clone()
    iu, ju = torch.triu_indices(n, n, 1, device=a.device)
    rounds = [(torch.tensor(p, device=a.device), torch.tensor(q, device=a.device))
              for p, q in round_robin_pairs(n)]
    active = torch.ones(K, dtype=torch.bool, device=a.device)
    sweeps = torch.zeros(K, dtype=torch.int64, device=a.device)
    for _ in range(MAX_SWEEPS):
        dg = torch.diagonal(A, dim1=1, dim2=2).abs().sqrt()
        sig = _significant(A[:, iu, ju], dg[:, iu], dg[:, ju], eps)
        active = active & sig.any(-1)
        if not bool(active.any()):
            break
        sweeps += active
        for p, q in rounds:
            A, V = _jacobi_round(A, V, p, q, active, eps)
    return torch.diagonal(A, dim1=1, dim2=2)[:, :m], V[:, :m, :m], sweeps


def _ordered_sum(terms: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis, left to right from +0 (the kernel's order)."""
    acc = torch.zeros(terms.shape[:-1], dtype=terms.dtype, device=terms.device)
    for i in range(terms.shape[-1]):
        acc = acc + terms[..., i]
    return acc


def clip_keep_ref(gram: torch.Tensor, clip_rtol: float) -> torch.Tensor:
    """Bool [K, m] keep-mask of the clip_rtol screen (all True when it is
    off): a column stays when its norm ‖y_i‖ = sqrt(max(gram_ii, 0)) is
    finite and clip_rtol·‖y_i‖ ≤ the median of the finite norms, the mean
    a + (b − a)·0.5 of the middle pair for an even count (as
    ``nanquantile(·, 0.5)``)."""
    K, m, _ = gram.shape
    if clip_rtol <= 0.0:
        return torch.ones((K, m), dtype=torch.bool, device=gram.device)
    dg = torch.diagonal(gram, dim1=1, dim2=2)
    norms = torch.where(dg < 0, 0.0, dg).sqrt()
    finite = torch.isfinite(norms)
    srt = torch.where(finite, norms, torch.inf).sort(-1).values
    nf = finite.sum(-1, keepdim=True)
    lo = torch.clamp((nf - 1) // 2, min=0)
    va, vb = srt.gather(-1, lo), srt.gather(-1, nf // 2)
    med = va + (vb - va) * 0.5
    return finite & (norms * clip_rtol <= med)


def aa_step_ref(w, g, s, y, gram, yg, eta: float, *, damping: float,
                tikhonov: float, filter_rtol: float, clip_rtol: float):
    """The AA step after the Gram pass, per client (csrc/update.cu
    ``repro_aa_step``):

    1. the clip_rtol screen (``clip_keep_ref``); a screened column leaves
       the system, the rhs, the Tikhonov diagonal and the update by
       selection (it may carry inf);
    2. the system gram + λI over the kept columns, λ = tikhonov·tr/m; a
       system with a non-finite entry gives Γ = NaN, used 0, cond 1;
    3. its eigendecomposition by ``jacobi_eigh_ref``;
    4. Γ = V diag(inv) Vᵀ rhs over the eigenvalues kept by filter_rtol and
       the near-zero guard; ‖Γ‖, cond, used, clipped, and
       θ = sqrt(clamp(1 − (Yᵀg·Γ)/max(‖g‖², 1e-30), 0, 1));
    5. w⁺ = w − ηg − β(SᵀΓ − ηYᵀΓ), the kept columns summed in order.

    w, g: [d] (shared) or [K, d]; s, y: [K, m, d]; gram [K, m, m] and
    yg [K, m] from the Gram pass. Returns (w⁺ [K, d] in w.dtype, Γ [K, m],
    θ, ‖Γ‖, cond [K], used, clipped [K] int64)."""
    a = acc_dtype(s.dtype)
    K, m, d = s.shape
    dev = s.device
    gram, yg = gram.to(a), yg.to(a)
    one = torch.ones((), dtype=a, device=dev)

    keep = clip_keep_ref(gram, clip_rtol)
    clipped = m - keep.sum(-1)
    A = torch.where(keep[:, :, None] & keep[:, None, :], gram, 0.0)
    rhs = torch.where(keep, yg, 0.0)
    diag = torch.diagonal(A, dim1=1, dim2=2)
    lam = (_ordered_sum(diag) * tikhonov) / torch.full((), m, dtype=a, device=dev)
    idx = torch.arange(m, device=dev)
    A[:, idx, idx] = torch.where(keep, diag + lam[:, None], diag)
    bad = ~torch.isfinite(A).flatten(1).all(-1)

    evals, V, _ = jacobi_eigh_ref(torch.where(bad[:, None, None], 0.0, A))
    ev = torch.where(evals < 0, 0.0, evals)
    emax = ev.max(-1, keepdim=True).values
    keep_e = (ev > emax * filter_rtol) & (
        ev > torch.where(emax < TINY, TINY, emax) * TINY)
    inv = torch.where(keep_e, one / torch.where(keep_e, ev, one), 0.0)
    proj = _ordered_sum((V * rhs[:, :, None]).transpose(1, 2))   # Vᵀ rhs
    coef = inv * proj
    gamma = _ordered_sum(V * coef[:, None, :])                # V coef
    gamma = torch.where(bad[:, None], torch.nan, gamma)
    used = keep_e.sum(-1)
    emax = emax[:, 0]
    emin = torch.where(keep_e, ev, emax[:, None]).min(-1).values
    cond = torch.where(used > 0, emax / torch.where(emin < TINY, TINY, emin),
                       one)
    gamma_norm = _ordered_sum(gamma * gamma).sqrt()

    ga = g.to(a).expand(K, d)
    gn2 = (ga * ga).sum(-1)
    proj2 = _ordered_sum(rhs * gamma)
    x = one - proj2 / torch.where(gn2 < TINY, TINY, gn2)
    theta = torch.where(x < 0, 0.0, torch.where(x > 1, one, x)).sqrt()

    sa, ya = s.to(a), y.to(a)
    s_g = torch.zeros((K, d), dtype=a, device=dev)
    y_g = torch.zeros((K, d), dtype=a, device=dev)
    for i in range(m):
        gi, ki = gamma[:, i, None], keep[:, i, None]
        s_g = torch.where(ki, s_g + gi * sa[:, i], s_g)
        y_g = torch.where(ki, y_g + gi * ya[:, i], y_g)
    out = (w.to(a) - ga * eta) - (s_g - y_g * eta) * damping
    return out.to(w.dtype), gamma, theta, gamma_norm, cond, used, clipped
