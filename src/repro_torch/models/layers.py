"""Transformer and Mamba-2 building blocks of the LM serving path
(counterpart of repro/models/layers.py, its serving subset).

Conventions, as in the reference:
* parameters are named as in the reference's nested dict (``wq``, ``wx``,
  ``A_log``, ...), held by a ``Params`` module so that a state dict path
  is the reference's path with the layer index inserted
  (core/convert.py::lm_params);
* dtype policy: parameters and activations in ``cfg.dtype`` (bf16 at full
  width), softmax, normalisation and SSM state math in f32. Each function
  rounds where the reference rounds (comments name the place).

Serving: no-cache attention (forward and prefill) goes to the
flash-attention kernel, whatever S is: the reference's materialized
softmax (S < 1024) and its blocked XLA path (``_attention_blocked``)
compute the same function, which the reference's Pallas kernel computes on
the TPU. The SSD intra-chunk step goes to the SSD kernel (the reference's
``ssd_fn`` hook). On CPU tensors both wrappers run their plain versions.

Training (``train=True``, the decoder's ``loss``): the reference trains
through its jnp paths, and so does the port, in plain torch: the
materialized softmax for S < 1024, ``_attention_blocked`` (an online
softmax over key blocks of 512) for S >= 1024 with S % 512 == 0, and the
jnp intra-chunk SSD step (``ssd_fn=None``). Neither calls a kernel
wrapper: a hand-written launch has no backward, and ``torch.func.grad``
and ``vmap`` (one point per client) cannot trace it. Both are
out-of-place and read nothing back to the host, so the engine captures
them.

MoE (``moe``): the reference's capacity dispatch in plain torch, for
serving and training alike; its expert products are plain products in the
reference too (no Pallas call). The dispatch builds an [E, C] buffer of
token ids and gathers rows, with no float atomics and no host read, so the
engine captures it and its backward (a sorted ``index_put_``) is
deterministic on the card.

GQA: in the ``grouped`` mode query head i reads KV slot i // G; in the
``gather`` mode (``padded()`` configs whose padded head map is not
uniform) the KV heads are gathered to one per query head (``kv_map``, from
the true head counts) and attention runs as MHA, on the flash kernel, the
training paths and decode alike, as the reference's gather path does.

The int8 KV cache (``kv_quant``): ``init_kv_cache(quant=True)`` holds int8
codes and an f32 scale per (slot, head) (``quantize_kv``); decode branches
on the cache's contents (``"k_scale" in cache``), as the reference, so a
prefill's model-dtype cache decodes unquantized.

Tensor parallelism (``Sharder``; sharding/specs.py's plan): every layer
function takes ``sh``, a no-op without a mesh, as in the reference. Under a
mesh a rank holds its shard of the plan's parameters (the shapes it reads
are those of its tensors) and computes its query and KV heads, its d_ff
columns, its experts (``moe_sharded``), its ``ssm_inner`` channels and
heads, and each layer ends in one sum over "model" (``Sharder.sum``, an
all-reduce in the activation's dtype, as the reference's psum). The
reference's GSPMD constraints keep every layer the unsharded function;
here that takes: the Mamba-2 gated norm's sum of squares over the whole
``d_inner`` (one [B, S, 1] f32 sum), the replicated conv state (the
rank's new conv rows gathered over "model"), and in the ``gather`` GQA
mode, where a rank's query heads read KV heads outside its KV slots, the
KV heads gathered over "model" before the head map.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd_chunk


# ---------------------------------------------------------------------------
# sharding helper
# ---------------------------------------------------------------------------

def _axes_of(axis) -> tuple:
    """A mesh axis, a tuple of them, or None as a tuple of axis names."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


class _AllReduce(torch.autograd.Function):
    """The sum of the ranks' partial x: all-reduce forward; identity
    backward (the sum is replicated, so its gradient is every rank's)."""

    @staticmethod
    def forward(x, sh, axis):
        y = x.clone(memory_format=torch.contiguous_format)
        sh._all_reduce(y, axis)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """A replicated x entering a rank's part of a split computation:
    identity forward; backward, the ranks' partial gradients summed (an
    all-reduce), so that what x feeds gets its whole gradient."""

    @staticmethod
    def forward(x, sh, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sh, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.sh._all_reduce(g, ctx.axis)
        return g, None, None


class _AllGather(torch.autograd.Function):
    """The ranks' parts of x concatenated along ``dim``: all-gather
    forward; backward, this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(x, sh, dim, axis):
        return sh._all_gather(x, dim, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.sh, ctx.dim, ctx.axis = inputs
        ctx.n = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        i = ctx.sh.axis_index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


class _FsdpGather(torch.autograd.Function):
    """A weight's fsdp shards gathered along ``dim`` over the fsdp axes
    (all-gather forward). Backward: where the batch is split over the fsdp
    axes, the ranks' gradients of the whole weight are summed and each
    keeps its part (a reduce-scatter); where it is split over some of them
    (the data axis of a mesh with pods), summed over those and then cut;
    where it is not split, each rank's gradient is already whole: cut."""

    @staticmethod
    def forward(x, sh, dim, axis, batch):
        return sh._all_gather(x, dim, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.sh, ctx.dim, ctx.axis, ctx.batch = inputs
        ctx.n = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        sh, dim, axis, batch = ctx.sh, ctx.dim, _axes_of(ctx.axis), ctx.batch
        if batch == axis:
            return sh._reduce_scatter(g, dim, axis), None, None, None, None
        if batch:
            g = g.clone(memory_format=torch.contiguous_format)
            sh._all_reduce(g, batch)
        i = sh.axis_index(axis)
        return g.narrow(dim, i * ctx.n, ctx.n).contiguous(), None, None, None, None


@dataclasses.dataclass(frozen=True)
class Sharder:
    """The reference's Sharder: a no-op without a mesh. With one
    (launch/mesh.py::Mesh), ``axes`` maps each logical axis ("heads",
    "kv_heads", "d_ff", "experts", "vocab", "ssm_inner", "batch", ...) to a
    mesh axis or None, and the Sharder gives this rank's slice of a logical
    axis (``local``), the sum of a partial result over "model" (``sum``),
    the entry of a replicated tensor into the rank's part of a split
    computation (``enter``), the concatenation of the ranks' parts
    (``gather``: an all-gather) and, in the ``fsdp`` regime, a weight
    gathered whole over the fsdp axes before use (``fetch``). None reads
    the host or uses float atomics.

    Autograd. Where gradients are on, each is a ``torch.autograd.Function``
    that ``torch.func.grad`` traces: ``sum`` all-reduces forward and
    passes the gradient through; ``enter`` passes x through and all-reduces
    its gradient (without it, the gradient of a replicated activation,
    norm, router or embedding would be one rank's part of the sum);
    ``gather`` all-gathers forward and keeps this rank's slice of the
    gradient; ``fetch`` all-gathers forward and reduce-scatters the
    gradient over the data ranks that computed on other rows
    (``_FsdpGather``). With gradients off (serving), ``sum`` all-reduces in
    place and ``enter`` does nothing.

    ``counts`` tallies the collectives by kind, forward and backward:
    calls and the bytes each rank puts in, in all and by mesh axis
    (``by_axis``). ``ctx["batch"]`` holds the mesh axes the running
    training forward split its batch over (``Decoder.forward_hidden``)."""

    mesh: Any = None
    axes: dict | None = None
    regime: str = "replica"
    multi_pod: bool = False
    counts: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)
    ctx: dict = dataclasses.field(default_factory=dict, compare=False,
                                  repr=False)

    def _mesh_axes(self, logical: str) -> tuple:
        if self.mesh is None:
            return ()
        return _axes_of((self.axes or {}).get(logical))

    def shards(self, logical: str) -> int:
        """The number of ranks a logical axis is split over (1 without a
        mesh, or where the plan replicates it)."""
        return math.prod(self.mesh.shape.get(a, 1) for a in self._mesh_axes(logical))

    def index(self, logical: str) -> int:
        """This rank's part of a logical axis (row-major over its mesh axes)."""
        return self.axis_index(self._mesh_axes(logical))

    def axis_index(self, axis) -> int:
        """This rank's index along a mesh axis or a tuple of them
        (row-major, the slowest first)."""
        idx = 0
        for a in _axes_of(axis):
            idx = idx * self.mesh.shape.get(a, 1) + self.mesh.coords.get(a, 0)
        return idx

    def local(self, n: int, logical: str) -> slice:
        """This rank's slice of a logical axis of size ``n``."""
        parts, i = self.shards(logical), self.index(logical)
        if n % parts:
            raise ValueError(f"{logical} of size {n} does not split over {parts} ranks")
        return slice(i * n // parts, (i + 1) * n // parts)

    # ----------------------------- collectives -----------------------------
    def _tally(self, kind: str, t: torch.Tensor, axis) -> None:
        c = self.counts.setdefault(kind, {"calls": 0, "bytes": 0, "by_axis": {}})
        n = t.numel() * t.element_size()
        c["calls"] += 1
        c["bytes"] += n
        a = c["by_axis"].setdefault(",".join(_axes_of(axis)), {"calls": 0, "bytes": 0})
        a["calls"] += 1
        a["bytes"] += n

    def _all_reduce(self, x: torch.Tensor, axis) -> None:
        """x summed in place over the ranks of ``axis`` (a mesh axis or a
        tuple of them)."""
        self._tally("all_reduce", x, axis)
        with record_function(f"tp.all_reduce.{','.join(_axes_of(axis))}"):
            dist.all_reduce(x, group=self.mesh.group(axis))

    def _all_gather(self, x: torch.Tensor, dim: int, axis) -> torch.Tensor:
        n = self.mesh.size(axis)
        self._tally("all_gather", x, axis)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        with record_function(f"tp.all_gather.{','.join(_axes_of(axis))}"):
            dist.all_gather(parts, x, group=self.mesh.group(axis))
        return torch.cat(parts, dim=dim)

    def _reduce_scatter(self, g: torch.Tensor, dim: int, axis) -> torch.Tensor:
        """The sum over the ranks of ``axis`` of g, cut along ``dim``: this
        rank's part."""
        n = self.mesh.size(axis)
        self._tally("reduce_scatter", g, axis)
        chunks = [c.contiguous() for c in g.chunk(n, dim)]
        out = torch.empty_like(chunks[0])
        with record_function(f"tp.reduce_scatter.{','.join(_axes_of(axis))}"):
            dist.reduce_scatter(out, chunks, group=self.mesh.group(axis))
        return out

    def sum(self, x: torch.Tensor, logical: str = "heads",
            axis: str = "model") -> torch.Tensor:
        """x summed over the ranks of ``axis``, where the plan splits
        ``logical`` (the axis whose split made x partial); x as it is
        otherwise. In place when gradients are off."""
        if not self._mesh_axes(logical):
            return x
        return self.sum_over(x, axis)

    def sum_over(self, x: torch.Tensor, axis) -> torch.Tensor:
        """x summed over the ranks of ``axis`` (a mesh axis, a tuple of
        them; none: x as it is)."""
        if not _axes_of(axis):
            return x
        if torch.is_grad_enabled():
            return _AllReduce.apply(x, self, axis)
        self._all_reduce(x, axis)
        return x

    def enter(self, x: torch.Tensor, logical: str, axis: str = "model") -> torch.Tensor:
        """A replicated x about to feed this rank's part of a computation
        that the plan splits along ``logical``: x itself, whose gradient is
        summed over ``axis`` on the way back (nothing without gradients, or
        where the plan does not split ``logical``)."""
        if not self._mesh_axes(logical) or not torch.is_grad_enabled():
            return x
        return _Enter.apply(x, self, axis)

    def gather(self, x: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
        """The ranks' parts of x concatenated along ``dim``, in rank order."""
        if torch.is_grad_enabled():
            return _AllGather.apply(x, self, dim, axis)
        return self._all_gather(x, dim, axis)

    # ------------------------------- batch --------------------------------
    def batch_axes(self, batch: int) -> tuple:
        """The mesh axes a batch of ``batch`` splits over (the reference's
        ``batch_axis``): ("pod", "data") on a mesh with pods where it
        divides, else "data" where it divides, else none."""
        if self.mesh is None:
            return ()
        data = self.mesh.shape.get("data", 1)
        if self.multi_pod and batch % (self.mesh.shape.get("pod", 1) * data) == 0:
            axes = ("pod", "data")
        elif batch % data == 0:
            axes = ("data",)
        else:
            return ()
        return tuple(a for a in axes if self.mesh.shape.get(a, 1) > 1)

    def batch_rows(self, batch: int) -> slice:
        """This rank's rows of a batch of ``batch``: its block over the
        batch axes where the batch divides over them, every row otherwise."""
        axes = self.batch_axes(batch)
        n = self.mesh.size(axes) if axes else 1
        i = self.axis_index(axes)
        return slice(i * batch // n, (i + 1) * batch // n)

    # -------------------------------- fsdp --------------------------------
    def fsdp_axes(self) -> tuple:
        """The mesh axes the fsdp regime splits weights over, where they
        have more than one rank; () otherwise."""
        if self.mesh is None or self.regime != "fsdp":
            return ()
        axes = ("pod", "data") if self.multi_pod else ("data",)
        return axes if self.mesh.size(axes) > 1 else ()

    def fsdp_dim(self, path: str, ndim: int) -> int | None:
        """The dim of parameter ``path`` that the fsdp axes split (its
        spec's), or None."""
        fa = self.fsdp_axes()
        if not fa:
            return None
        key = (path, ndim)
        cache = self.ctx.setdefault("fsdp_dims", {})
        if key not in cache:
            from repro_torch.sharding.specs import param_spec_for_path
            spec = param_spec_for_path(path, ndim, self)
            cache[key] = next((i for i, e in enumerate(spec)
                               if e is not None and _axes_of(e) == fa), None)
        return cache[key]

    def fetch(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``path`` (its state-dict name) as a layer reads it: in
        the fsdp regime, its shards all-gathered over the fsdp axes (the
        reference's "gathered per-layer"); itself otherwise."""
        dim = self.fsdp_dim(path, t.ndim)
        if dim is None:
            return t
        fa = self.fsdp_axes()
        if torch.is_grad_enabled():
            return _FsdpGather.apply(t, self, dim, fa, tuple(self.ctx.get("batch", ())))
        return self._all_gather(t, dim, fa)


#: the Sharder of a model without a mesh
NO_SHARDER = Sharder()


def default_axes(multi_pod: bool = False) -> dict:
    batch = ("pod", "data") if multi_pod else "data"
    return {
        "batch": batch,
        "seq": None,
        "heads": "model",
        "kv_heads": "model",     # overridden to None when kv % shards != 0
        "d_model": None,
        "d_ff": "model",
        "experts": "model",      # overridden to None when E % shards != 0
        "expert_ff": None,       # flipped to "model" when experts replicated
        "vocab": "model",
        "ssm_inner": "model",
        "ssm_state": None,
    }


class Params(nn.Module):
    """A flat group of parameters named as in the reference's dict. The
    serving path takes no gradients: every parameter is frozen. In the
    fsdp regime the decoder binds each group to its Sharder and state-dict
    prefix (``bind``), and a layer reads each weight gathered whole
    (``Sharder.fetch``)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def bind(self, sh: "Sharder", prefix: str) -> None:
        self._sh, self._prefix = sh, prefix

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self._parameters[name]
        sh = self.__dict__.get("_sh")
        return t if sh is None else sh.fetch(self._prefix + name, t)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In f32, cast back to x's dtype (as the reference)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exponent)          # f32, as the reference


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (int). Rotates interleaved
    (even, odd) pairs; angles in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    ang = positions[..., None].float() * freqs                # [B, S, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def dense_init(gen: torch.Generator | None, shape, in_axis_size: int, dtype,
               device) -> torch.Tensor:
    """normal x 1/sqrt(fan_in), drawn in f32 on the generator's device from
    ``gen``, then cast to ``dtype`` on ``device``; without ``gen`` (a model
    on the meta device: shapes only), an empty tensor of that shape."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(in_axis_size)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(scale).to(device=device, dtype=dtype)


def _whole(name: str, t: torch.Tensor) -> torch.Tensor:
    return t


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm, full-causal or sliding-window, KV cache)
# ---------------------------------------------------------------------------

def gqa_mode(cfg) -> str:
    """'grouped' when query head i reads kv slot i // G (G = H // KV_eff)
    and that reproduces the true mapping i -> i * KV // H; else 'gather'."""
    H, KVe = cfg.eff_heads, cfg.eff_kv_heads
    KV, Ht = cfg.num_kv_heads, cfg.num_heads
    if not H or H % KVe != 0 or KVe % KV != 0:
        return "gather"
    G, r = H // KVe, KVe // KV
    for i in range(Ht):
        if (i // G) // r != (i * KV) // Ht:
            return "gather"
    return "grouped"


def _kv_of_head(cfg, i: int) -> int:
    """The ``gather`` mode's KV head of query head i (layers.py:294-297)."""
    if i < cfg.num_heads:
        return (i * cfg.num_kv_heads) // cfg.num_heads
    return i % cfg.eff_kv_heads


def kv_map(cfg, device, heads: range | None = None) -> torch.Tensor:
    """The ``gather`` mode's KV head of each query head in ``heads`` (all
    H by default), from the true counts (layers.py:294-297): (i·KVt)//Ht
    for a true head i < Ht, i % KV for a padded one (its output dies on its
    zero ``wo`` rows). Computed on the device, so that no step copies a
    host list there."""
    heads = range(cfg.eff_heads) if heads is None else heads
    i = torch.arange(heads.start, heads.stop, device=device)
    Ht, KVt = cfg.num_heads, cfg.num_kv_heads
    return torch.where(i < Ht, (i * KVt) // Ht, i % cfg.eff_kv_heads)


def kv_read(cfg, sh: Sharder = NO_SHARDER) -> tuple[str, range, int]:
    """How this rank's query heads read the KV heads it holds: (how, its
    query heads, the first KV head it holds). ``how`` is "as_is" (the
    ``grouped`` map: local query head j reads held slot j // G, so the
    flash kernel's GQA reads them as they are; a plan splits the KV heads
    with the query heads, or holds the one KV head of MQA whole), "local"
    (the ``gather`` map's heads all lie in the held slots: index those) or
    "gathered" (they do not: all-gather the KV heads over "model", then
    index by the global map). The all-gather is a collective: where any
    rank of the group reads outside its slots, every rank gathers. Decided
    from the config alone, with no device read."""
    hs = sh.local(cfg.eff_heads, "heads")
    ks = sh.local(cfg.eff_kv_heads, "kv_heads")
    heads = range(hs.start, hs.stop)
    if gqa_mode(cfg) == "grouped":
        return "as_is", heads, ks.start
    if not kv_outside(cfg, sh.shards("heads"), sh.shards("kv_heads")):
        return "local", heads, ks.start
    return "gathered", heads, 0


def kv_outside(cfg, head_shards: int, kv_shards: int) -> list[int]:
    """The ranks whose query heads' KV heads (the ``gather`` map) lie
    outside the KV slots they hold, for heads split over ``head_shards``
    ranks and KV heads over ``kv_shards`` (1: replicated)."""
    H, KV = cfg.eff_heads, cfg.eff_kv_heads
    out = []
    for r in range(head_shards):
        k0, k1 = ((r * KV // kv_shards, (r + 1) * KV // kv_shards)
                  if kv_shards > 1 else (0, KV))
        if not all(k0 <= _kv_of_head(cfg, i) < k1
                   for i in range(r * H // head_shards, (r + 1) * H // head_shards)):
            out.append(r)
    return out


def _gather_kv(cfg, k: torch.Tensor, sh: Sharder = NO_SHARDER) -> torch.Tensor:
    """k [B, S, KV_held, hd] as this rank's query heads read it: as it is
    (``as_is``: the flash kernel's GQA map), else one KV head per query
    head [B, S, H_held, hd], after an all-gather of the KV heads over
    "model" where they lie outside the held slots."""
    how, heads, kv0 = kv_read(cfg, sh)
    if how == "as_is":
        return k
    if how == "gathered":
        # every rank's KV heads, read by this rank's query heads only
        k = sh.enter(sh.gather(k, dim=2), "heads")
    return k.index_select(2, kv_map(cfg, k.device, heads) - kv0)


def attn_init(gen, cfg, dtype, device, keep=_whole) -> Params:
    """``keep(name, tensor)``: what the caller keeps of each parameter as
    it is drawn (under a mesh a rank's shard: the decoder's ``_part``), so
    that one full tensor at a time is held."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.eff_heads, cfg.eff_kv_heads
    KV_true = cfg.num_kv_heads

    def kv_proj():
        if gqa_mode(cfg) == "grouped" and KV != KV_true and KV % KV_true == 0:
            # replicated-kv layout: padded slots repeat the true kv heads
            w = dense_init(gen, (d, KV_true, hd), d, dtype, device)
            return w.repeat_interleave(KV // KV_true, dim=1).reshape(d, KV * hd)
        return dense_init(gen, (d, KV * hd), d, dtype, device)

    p = {"wq": keep("wq", dense_init(gen, (d, H * hd), d, dtype, device))}
    p["wk"] = keep("wk", kv_proj())
    p["wv"] = keep("wv", kv_proj())
    wo = dense_init(gen, (H * hd, d), H * hd, dtype, device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    if cfg.eff_heads != cfg.num_heads:
        # zero the padded heads' output rows: padded heads are no-ops
        mask = (torch.arange(H * hd, device=device) < cfg.num_heads * hd).to(dtype)
        wo = wo * mask[:, None]
    p["wo"] = keep("wo", wo)
    return Params(p)


def _attn_scores_mask(q_pos, k_pos, window: int):
    """[.., Sq, Sk] boolean mask: causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def _attn_scale(hd: int) -> float:
    """1/sqrt(hd) in f32, as the reference (a Python float holding that
    value)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd))))


def _attention_blocked(q5, k, v, positions, window: int, block: int = 512):
    """The reference's flash-style blocked attention in plain torch
    (layers.py:165-210): an online softmax over key blocks of ``block``, in
    f32, so the [Sq, Sk] scores are never held whole. q5: [B, Sq, KV, G,
    hd] (grouped layout); k, v: [B, Sk, KV, hd]. Returns [B, Sq, KV, G, hd]
    in q5's dtype."""
    B, Sq, KV, G, hd = q5.shape
    Sk = k.shape[1]
    block = min(block, Sk)            # the caller's S % 512 == 0: whole blocks
    scale = _attn_scale(hd)
    q32 = q5.float()
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q5.device)
    m = torch.full((B, KV, G, Sq), -1e30, dtype=torch.float32, device=q5.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q5.device)
    for b0 in range(0, Sk, block):
        k_b, v_b = k[:, b0:b0 + block].float(), v[:, b0:b0 + block].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", q32, k_b) * scale
        mask = _attn_scores_mask(positions, positions[:, b0:b0 + block], window)
        s = torch.where(mask[:, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        pr = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", pr, v_b)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)       # [B, KV, G, Sq, hd]
    return out.permute(0, 3, 1, 2, 4).to(q5.dtype)


def _attention_train(q, k, v, positions, window: int, dtype):
    """The reference's no-cache grouped attention (layers.py:278-289,
    :294-301): q [B, S, H, hd], k and v [B, S, KV, hd] → [B, S, H·hd]. The
    materialized softmax (scores rounded to ``dtype``, then an f32
    softmax, probabilities back in ``dtype``) for S < 1024; the blocked
    path for S >= 1024 with S % 512 == 0."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    q5 = q.reshape(B, S, KV, H // KV, hd)
    if S >= 1024 and S % 512 == 0:
        return _attention_blocked(q5, k, v, positions, window).reshape(B, S, H * hd)
    mask = _attn_scores_mask(positions, positions, window)          # [B, S, S]
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5, k).float()
    logits = torch.where(mask[:, None, None], logits * _attn_scale(hd), -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(B, S, H * hd)


def attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
              cache: dict | None = None, window: int = 0, train: bool = False,
              sh: Sharder = NO_SHARDER):
    """x: [B, S, d]. Returns (out [B, S, d], k, v): this call's k (after
    rope) and v, [B, S, KV, hd], which prefill writes into its caches.

    Without ``cache`` (forward, prefill; positions are 0..S-1): the flash
    kernel, or with ``train`` the reference's training attention in plain
    torch (``_attention_train``). With ``cache`` (decode, S == 1): one
    layer's view of the KV ring buffer {"k", "v": [B, C, KV, hd], "pos":
    [B, C], "idx": 0-d}, updated in place: this step's k/v and positions
    go to slot idx % C, then idx += 1 (the reference returns a new cache;
    the port writes into the one it was given). A cache that holds
    "k_scale" and "v_scale" [B, C, KV, 1] is the int8 one: the step is
    written as codes and scales, and read back dequantized to x's dtype.
    In the ``gather`` mode the KV heads are gathered to H (``_gather_kv``)
    after the cache, which keeps KV heads.

    Under a mesh (``sh``) the rank holds its query heads' columns of
    ``wq`` and rows of ``wo`` and its KV heads' columns of ``wk``/``wv``
    (all of them where the plan replicates KV heads: MQA); H and KV are
    the held counts, its k/v and cache hold its KV heads, and the output
    is summed over "model". For training, x (and what the plan replicates
    over "model": the KV projections of MQA, the qk-norm scales) enters
    the rank's heads (``Sharder.enter``)."""
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    wq, wk, wv, wo = p["wq"], p["wk"], p["wv"], p["wo"]
    H, KV = wq.shape[1] // hd, wk.shape[1] // hd
    x = sh.enter(x, "heads")
    if not sh.shards("kv_heads") > 1:
        wk, wv = sh.enter(wk, "heads"), sh.enter(wv, "heads")
    q = (x @ wq).reshape(B, S, H, hd)
    k = (x @ wk).reshape(B, S, KV, hd)
    v = (x @ wv).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, sh.enter(p["q_norm"], "heads"))
        k = rms_norm(k, sh.enter(p["k_norm"], "heads"))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        k_use, v_use = _gather_kv(cfg, k, sh), _gather_kv(cfg, v, sh)
        if train:
            out = _attention_train(q, k_use, v_use, positions, window, x.dtype)
            return sh.sum(out @ wo), k, v
        out = flash_attention(q, k_use, v_use, causal=True, window=window)
        return sh.sum(out.reshape(B, S, H * hd) @ wo), k, v

    if S != 1:
        raise ValueError(f"attention with a cache decodes one token; got S={S}")
    C = cache["k"].shape[1]
    slot = (cache["idx"] % C).long().reshape(1)
    cache["pos"].index_copy_(1, slot, positions.to(cache["pos"].dtype))
    cache["idx"].add_(1)
    if "k_scale" in cache:
        # int8: write codes and scales; read k_all·k_sc and v_all·v_sc in
        # f32, each rounded to x's dtype (layers.py:241-254)
        for name, t in (("k", k), ("v", v)):
            codes, scale = quantize_kv(t)
            cache[name].index_copy_(1, slot, codes)
            cache[name + "_scale"].index_copy_(1, slot, scale)
        k_all = (cache["k"].float() * cache["k_scale"]).to(x.dtype)
        v_all = (cache["v"].float() * cache["v_scale"]).to(x.dtype)
    else:
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        k_all, v_all = cache["k"], cache["v"]
    k_all, v_all = _gather_kv(cfg, k_all, sh), _gather_kv(cfg, v_all, sh)
    k_pos = cache["pos"]

    scale = _attn_scale(hd)
    mask = _attn_scores_mask(positions, k_pos, window)             # [B, Sq, Sk]
    mask = mask & (k_pos >= 0)[:, None]       # never-written slots: pos = -1
    KVa = k_all.shape[2]
    q5 = q.reshape(B, S, KVa, H // KVa, hd)
    # scores rounded to the model dtype, then the f32 softmax; the
    # probabilities go back to the model dtype for p v (layers.py:283-289)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5, k_all).float()
    logits = torch.where(mask[:, None, None], logits * scale, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_all).reshape(B, S, H * hd)
    return sh.sum(out @ wo), k, v


#: the int8 KV cache's scale is max|x| · fl(1/127): the jitted reference
#: compiles its division by the constant 127 so (XLA turns a division by a
#: constant into a product by its reciprocal), one ulp off the quotient in
#: some rows; the product is a plain IEEE operation the port can match
_INV_127 = float(torch.tensor(1.0) / torch.tensor(127.0))


def quantize_kv(x: torch.Tensor):
    """One decode step's k or v, [B, 1, KV, hd], as int8 codes and f32
    scales [B, 1, KV, 1] (the reference's ``_quantize_kv``, layers.py:339-344):
    scale = max|x| over hd, in f32, times fl(1/127), at least 1e-8; codes =
    round(x / scale) (half to even, as ``jnp.round``) clipped to ±127."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(-1, keepdim=True) * _INV_127, min=1e-8)
    codes = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def init_kv_cache(cfg, layers: int, batch: int, cache_len: int, dtype,
                  device, quant: bool = False, kv_heads: int | None = None) -> dict:
    """KV ring buffers of ``layers`` layers, stacked on a leading axis;
    with ``quant`` the int8 cache: int8 "k", "v" and f32 "k_scale",
    "v_scale" [layers, B, C, KV, 1] (layers.py:320-330). ``kv_heads``: the
    KV heads a rank holds (all by default)."""
    KV, hd = kv_heads or cfg.eff_kv_heads, cfg.resolved_head_dim
    kv_dtype = torch.int8 if quant else dtype
    out = {
        "k": torch.zeros((layers, batch, cache_len, KV, hd), dtype=kv_dtype, device=device),
        "v": torch.zeros((layers, batch, cache_len, KV, hd), dtype=kv_dtype, device=device),
    }
    if quant:
        for name in ("k_scale", "v_scale"):
            out[name] = torch.zeros((layers, batch, cache_len, KV, 1),
                                    dtype=torch.float32, device=device)
    out["pos"] = torch.full((layers, batch, cache_len), -1, dtype=torch.int32, device=device)
    out["idx"] = torch.zeros((layers,), dtype=torch.int32, device=device)
    return out


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, f: int, dtype, device, keep=_whole) -> Params:
    return Params({"wi_gate": keep("wi_gate", dense_init(gen, (d, f), d, dtype, device)),
                   "wi_up": keep("wi_up", dense_init(gen, (d, f), d, dtype, device)),
                   "wo": keep("wo", dense_init(gen, (f, d), f, dtype, device))})


def mlp(p: Params, x: torch.Tensor, sh: Sharder = NO_SHARDER) -> torch.Tensor:
    """SwiGLU; under a mesh ``wi_gate``/``wi_up`` hold the rank's d_ff
    columns and ``wo`` its rows, and the output is summed over "model"
    (x enters the rank's columns: ``Sharder.enter``)."""
    x = sh.enter(x, "d_ff")
    return sh.sum((F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"], "d_ff")


# ---------------------------------------------------------------------------
# MoE (capacity-based dispatch; the reference's ``moe``)
# ---------------------------------------------------------------------------

def moe_init(gen, cfg, dtype, device, keep=_whole) -> Params:
    """The router [d, E] in f32 whatever ``dtype``; the experts' SwiGLU
    weights [E, d, f], [E, d, f], [E, f, d] in ``dtype`` (layers.py:460)."""
    d, E, f = cfg.d_model, cfg.eff_experts, cfg.moe_d_ff
    return Params({
        "router": keep("router", dense_init(gen, (d, E), d, torch.float32, device)),
        "wi_gate": keep("wi_gate", dense_init(gen, (E, d, f), d, dtype, device)),
        "wi_up": keep("wi_up", dense_init(gen, (E, d, f), d, dtype, device)),
        "wo": keep("wo", dense_init(gen, (E, f, d), f, dtype, device))})


def moe_top_k(probs: torch.Tensor, k: int):
    """(gate_w, gate_i) [T, k]: the k most probable experts of each token,
    by a stable descending sort, so that equal probabilities take the lower
    expert first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
    order among ties); their probabilities renormalised to sum to 1."""
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = gate_w[:, :k], gate_i[:, :k]
    return gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9), gate_i


def moe_route(p: Params, xt: torch.Tensor, cfg, dropless: bool = False):
    """The router of ``moe`` on tokens xt [T, d]: (gate_w [T, k] f32,
    gate_i [T, k], aux, flat_e [T·k], pos [T·k], keep [T·k], capacity).

    Assignment j = t·k + i (token-major) sits at position pos[j] of expert
    flat_e[j]: the number of earlier assignments to that expert (the cumsum
    of the one-hot); it is kept if pos < capacity."""
    T = xt.shape[0]
    E, k = cfg.eff_experts, cfg.experts_per_token
    experts = torch.arange(E, device=xt.device)
    logits = xt.float() @ p["router"]                               # [T, E]
    if E != cfg.num_experts:
        # padded (dummy) experts are masked out of routing entirely
        logits = torch.where(experts >= cfg.num_experts, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = moe_top_k(probs, k)

    # load-balance aux loss (Switch): E · Σ_e fraction_e · prob_e
    frac = (gate_i[:, :1] == experts).float().mean(0)
    aux = E * torch.sum(frac * probs.mean(0))

    capacity = T * k if dropless else max(int(cfg.capacity_factor * T * k / E), 1)
    flat_e = gate_i.reshape(-1)                                     # [T·k]
    # the one-hot laid out [E, T·k], so that the cumsum runs along the
    # contiguous dim: along dim 0 of [T·k, E], CUDA scans each of the E
    # columns with one thread (a granite-moe-3b-a800m prefill of 4 x 2048
    # took 692 ms of device time so, 136 ms this way: chip_smoke.py phase
    # 6c on an H100 80GB HBM3 at 700 W)
    onehot = (experts[:, None] == flat_e).to(torch.int32)           # [E, T·k]
    pos = torch.cumsum(onehot, dim=1).gather(0, flat_e[None])[0] - 1
    return gate_w, gate_i, aux, flat_e, pos, pos < capacity, capacity


def moe(p: Params, x: torch.Tensor, cfg, dropless: bool = False):
    """x [B, S, d] -> (out [B, S, d], aux: the Switch load-balance loss, f32).

    ``dropless`` (decode) takes capacity T·k, so no token drops; forward,
    prefill and training keep the capacity factor (layers.py:471-526).
    Each expert's [C] slots hold the ids of its kept tokens, scattered into
    an [E, C + 1] buffer whose last column takes every dropped assignment
    (so none lands on a kept one) and is cut off; the [E, C, d] inputs are
    rows of xt gathered by id, id T being a zero row. The outputs come back
    by indexing, weighted in the model dtype and summed over the k slots."""
    B, S, d = x.shape
    E, k = cfg.eff_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, d)
    gate_w, _, aux, flat_e, pos, keep, C = moe_route(p, xt, cfg, dropless)

    tok_id = torch.arange(T * k, device=x.device) // k
    ids = torch.full((E, C + 1), T, dtype=torch.int64, device=x.device).index_put(
        (flat_e, torch.where(keep, pos, C)), tok_id)[:, :C]
    xt_pad = torch.cat([xt, xt.new_zeros(1, d)])
    buf = xt_pad[ids]                                               # [E, C, d]

    h = F.silu(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    yb = torch.bmm(h, p["wo"])                                      # [E, C, d]

    y_tok = torch.where(keep[:, None], yb[flat_e, torch.where(keep, pos, C - 1)], 0)
    w_flat = gate_w.reshape(-1, 1).to(x.dtype)
    y = (y_tok * w_flat).reshape(T, k, d).sum(1)
    return y.reshape(B, S, d), aux


def moe_sharded(p: Params, x: torch.Tensor, cfg, sh: Sharder,
                dropless: bool = False):
    """Expert-parallel MoE (layers.py:372-457): x [B, S, d] (the rank's
    batch rows, replicated over "model") -> (out [B, S, d], aux).

    The router is replicated: every rank routes all T tokens (``moe_route``),
    so the cumsum positions and the capacity are those of the whole T, as
    the unsharded ``moe``'s. The rank holds experts [e0, e0 + E/W) (its
    slices of ``wi_gate``, ``wi_up``, ``wo``), dispatches only the
    assignments to them (the others, and dropped ones, go to a dump row and
    column that are cut off), runs their products, and adds its weighted
    outputs; one sum over "model" is the layer's collective. With W = 1 it
    is ``moe``'s arithmetic, step for step. ``aux`` is every rank's (the
    decoder averages it over "data" when the batch is split).

    For training, the tokens and the gate weights enter the rank's experts
    (``Sharder.enter``: their gradients from the experts are summed over
    "model"), while the router's own path (the aux loss) is replicated."""
    B, S, d = x.shape
    E, k = cfg.eff_experts, cfg.experts_per_token
    wig, wiu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    E_loc = wig.shape[0]
    if sh.shards("experts") * E_loc != E:
        raise NotImplementedError(
            f"moe_sharded holds whole experts: {E} experts over "
            f"{sh.shards('experts')} ranks with {E_loc} each (the plan pads "
            "the experts to the model axis)")
    e0 = sh.index("experts") * E_loc
    T = B * S
    xt = x.reshape(T, d)
    gate_w, _, aux, flat_e, pos, keep, C = moe_route(p, xt, cfg, dropless)

    local_e = flat_e - e0
    keep = keep & (local_e >= 0) & (local_e < E_loc)
    tok_id = torch.arange(T * k, device=x.device) // k
    ids = torch.full((E_loc + 1, C + 1), T, dtype=torch.int64, device=x.device).index_put(
        (torch.where(keep, local_e, E_loc), torch.where(keep, pos, C)), tok_id)[:E_loc, :C]
    xe = sh.enter(xt, "experts")
    xt_pad = torch.cat([xe, xe.new_zeros(1, d)])
    buf = xt_pad[ids]                                               # [E_loc, C, d]

    h = F.silu(torch.bmm(buf, wig)) * torch.bmm(buf, wiu)
    yb = torch.bmm(h, wo)                                           # [E_loc, C, d]

    y_tok = torch.where(keep[:, None], yb[torch.where(keep, local_e, 0),
                                          torch.where(keep, pos, C - 1)], 0)
    w_flat = sh.enter(gate_w, "experts").reshape(-1, 1).to(x.dtype)
    y = (y_tok * w_flat).reshape(T, k, d).sum(1)
    return sh.sum(y, "experts").reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD) mixer
# ---------------------------------------------------------------------------

def mamba_init(gen, cfg, dtype, device, keep=_whole) -> Params:
    """Projections kept separate, as in the reference (wx, wz, wB, wC, wdt;
    the conv split into its x and B/C channels)."""
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, W = cfg.ssm_heads, cfg.ssm_conv_width
    f32 = torch.float32
    return Params({
        "wx": keep("wx", dense_init(gen, (d, di), d, dtype, device)),
        "wz": keep("wz", dense_init(gen, (d, di), d, dtype, device)),
        "wB": keep("wB", dense_init(gen, (d, st), d, dtype, device)),
        "wC": keep("wC", dense_init(gen, (d, st), d, dtype, device)),
        "wdt": keep("wdt", dense_init(gen, (d, nh), d, dtype, device)),
        "conv_x_w": keep("conv_x_w", dense_init(gen, (W, di), W, dtype, device)),
        "conv_x_b": torch.zeros(di, dtype=dtype, device=device),
        "conv_bc_w": keep("conv_bc_w", dense_init(gen, (W, 2 * st), W, dtype, device)),
        "conv_bc_b": torch.zeros(2 * st, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=device)),
        "D": torch.ones(nh, dtype=f32, device=device),
        "dt_bias": torch.zeros(nh, dtype=f32, device=device),
        "norm": torch.ones(di, dtype=dtype, device=device),
        "out_proj": keep("out_proj", dense_init(gen, (di, d), di, dtype, device)),
    })


def _ssd_intra_chunk(xc, dtc, dA_cumsum, Bc, Cc):
    """The reference's jnp intra-chunk step (layers.py:582-600, ``ssd_fn``
    None), which it trains through: the diagonal block's output y_diag [B,
    nc, Q, nh, hd] and each chunk's final state [B, nc, nh, hd, st]."""
    Q = xc.shape[2]
    # L[i, j] = exp(dA_cum[i] - dA_cum[j]) for i >= j; the mask comes before
    # the exp, so the non-causal entries (seg > 0) cannot overflow into NaN
    # gradients
    seg = dA_cumsum[:, :, :, None, :] - dA_cumsum[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, -1e30))
    cb = torch.einsum("bcqs,bcks->bcqk", Cc, Bc)             # [B, nc, Q, Q]
    att = cb[..., None] * decay                              # [B, nc, Q, Q, nh]
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bcqkh,bckhd->bcqhd", att, xdt)
    decay_last = torch.exp(dA_cumsum[:, :, -1:, :] - dA_cumsum)
    chunk_state = torch.einsum("bcqs,bcqh,bcqhd->bchds", Bc, dtc * decay_last, xc)
    return y_diag, chunk_state


def _ssd_chunked_scan(xh, dt, A, Bm, Cm, chunk: int, train: bool = False):
    """SSD forward (Mamba2, arXiv:2405.21060 §6), chunked dual form.

    xh: [B, S, nh, hd]; dt: [B, S, nh] (softplus'd); A: [nh] (negative);
    Bm/Cm: [B, S, st]; all f32. Returns y [B, S, nh, hd] and the final
    state [B, nh, hd, st]. The intra-chunk step is the SSD kernel, or with
    ``train`` the reference's jnp step (``_ssd_intra_chunk``); the
    recurrence over chunks is a loop of out-of-place torch ops (the
    reference's associative scan, taken in order).
    """
    B, S, nh, hd = xh.shape
    st = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"the chunked SSD scan needs S ({S}) to be a multiple "
                         f"of its chunk ({chunk})")
    nc, Q = S // chunk, chunk
    xc = xh.reshape(B, nc, Q, nh, hd).contiguous()
    dtc = dt.reshape(B, nc, Q, nh).contiguous()
    Bc = Bm.reshape(B, nc, Q, st).contiguous()
    Cc = Cm.reshape(B, nc, Q, st).contiguous()

    dA_cumsum = torch.cumsum(dtc * A, dim=2)            # within-chunk cumsum
    intra = _ssd_intra_chunk if train else ssd_chunk
    y_diag, chunk_state = intra(xc, dtc, dA_cumsum, Bc, Cc)

    # inter-chunk recurrence: state after chunk c = state(c-1) * decay_c + s_c
    chunk_decay = torch.exp(dA_cumsum[:, :, -1, :])     # [B, nc, nh]
    run = chunk_state[:, 0]
    states = [run]
    for c in range(1, nc):
        run = run * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
        states.append(run)
    # state entering chunk c = states[c-1]; zero for the first
    prev_states = torch.stack([torch.zeros_like(run)] + states[:-1], dim=1)

    # contribution of the carried-in state to each position of the chunk
    state_decay = torch.exp(dA_cumsum)                  # [B, nc, Q, nh]
    y_off = torch.einsum("bcqs,bchds,bcqh->bcqhd", Cc, prev_states, state_decay)
    y = (y_diag + y_off).reshape(B, S, nh, hd)
    return y, run


def mamba_forward(p: Params, x: torch.Tensor, cfg, state: dict | None = None,
                  train: bool = False, sh: Sharder = NO_SHARDER):
    """Mamba2 block. Prefill/forward when ``state`` is None (chunked SSD;
    with ``train`` its intra-chunk step in plain torch, ``_ssd_intra_chunk``);
    a single-token recurrent step when it is one layer's view
    {"conv": [B, W-1, conv_dim], "ssm": [B, nh, hd, st]}, which is updated
    in place. Returns (out [B, S, d], new state {"conv", "ssm"}).

    Under a mesh that splits ``ssm_inner`` (layers.py:628-689 with
    ``ssm_inner`` on "model"), the rank holds its channels of ``wx``,
    ``wz``, ``conv_x_w`` and ``out_proj`` and runs its heads (nh/W of them,
    whole heads); ``wB``, ``wC``, ``wdt``, the conv bias, ``A_log``, ``D``,
    ``dt_bias`` and the norm are replicated and read at its channels or
    heads. The gated norm's mean square over the whole ``d_inner`` is one
    f32 sum over "model"; the conv state (replicated, as the reference's
    cache spec) takes every rank's new x rows by one all-gather (not with
    ``train``, whose state goes unused); the ssm state holds the rank's
    heads; the output is summed over "model". For training, x and the
    replicated parameters enter the rank's channels (``Sharder.enter``),
    and so does the gated norm's sum."""
    B, S, d = x.shape
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dtype = x.dtype
    wx = p["wx"]
    di_loc = wx.shape[1]
    split = di_loc != di

    def rep(name):
        # a replicated parameter, read at the rank's channels or heads
        return sh.enter(p[name], "ssm_inner")
    if split and nh % sh.shards("ssm_inner"):
        raise NotImplementedError(
            f"{nh} SSM heads do not split over {sh.shards('ssm_inner')} ranks: "
            "the port splits ssm_inner by whole heads")
    ch, hs = sh.local(di, "ssm_inner"), sh.local(nh, "ssm_inner")
    nh_loc = di_loc // hd
    x = sh.enter(x, "ssm_inner")
    xz = x @ wx
    z = x @ p["wz"]
    Bm = x @ rep("wB")
    Cm = x @ rep("wC")
    dt_raw = x @ rep("wdt")

    conv_in = torch.cat([xz, Bm, Cm], dim=-1)             # [B, S, di_loc + 2st]
    W = cfg.ssm_conv_width
    if state is None:
        pad = torch.zeros((B, W - 1, conv_in.shape[-1]), dtype=dtype, device=x.device)
        cseq = torch.cat([pad, conv_in], dim=1)
    else:
        prev = state["conv"]
        if split:
            prev = torch.cat([prev[..., ch], prev[..., di:]], dim=-1)
        cseq = torch.cat([prev, conv_in], dim=1)
    new_conv_state = cseq[:, S:]                          # the last W-1 rows
    if split and not train:
        # the replicated conv state: every rank's x channels, then B and C
        new_conv_state = torch.cat([sh.gather(new_conv_state[..., :di_loc], dim=-1),
                                    new_conv_state[..., di_loc:]], dim=-1)
    # depthwise causal conv: the reference's einsum over the W taps
    # ("bswc,wc->bsc") accumulates in f32 and rounds once to the model
    # dtype, then adds the bias in the model dtype
    wfull = torch.cat([p["conv_x_w"], rep("conv_bc_w")], dim=-1).float()
    bfull = torch.cat([rep("conv_x_b")[ch], rep("conv_bc_b")], dim=-1)
    acc = cseq[:, 0:S].float() * wfull[0]
    for w in range(1, W):
        acc = acc + cseq[:, w:w + S].float() * wfull[w]
    conv_out = F.silu(acc.to(dtype) + bfull)
    xc, Bc, Cc = torch.split(conv_out, [di_loc, st, st], dim=-1)

    # dt in f32; x, B and C cast to f32 before the scan (layers.py:662-665)
    dt = F.softplus(dt_raw[..., hs].float() + rep("dt_bias")[hs])  # [B, S, nh_loc]
    A = -torch.exp(rep("A_log")[hs])                      # [nh_loc], < 0
    xh = xc.reshape(B, S, nh_loc, hd).float()
    Bc32, Cc32 = Bc.float(), Cc.float()

    if state is None:
        y, final_state = _ssd_chunked_scan(xh, dt, A, Bc32, Cc32,
                                           min(cfg.ssm_chunk, S), train)
    else:
        # recurrent step: h <- exp(dt A) h + dt B (x) x ;  y = C . h
        dA = torch.exp(dt[:, 0] * A[None])                # [B, nh]
        h = state["ssm"] * dA[..., None, None]
        h = h + (dt[:, 0, :, None] * xh[:, 0])[..., None] * Bc32[:, 0, None, None, :]
        y = torch.einsum("bs,bhds->bhd", Cc32[:, 0], h)[:, None]   # [B, 1, nh, hd]
        final_state = h
        state["conv"].copy_(new_conv_state)
        state["ssm"].copy_(final_state)

    # y + D x in f32, then the model dtype before the gate (layers.py:684-686)
    y = y + xh * rep("D")[hs][None, None, :, None]
    y = y.reshape(B, S, di_loc).to(dtype)
    y = y * F.silu(z)
    if split:
        # the norm's mean square over the whole d_inner: one f32 sum
        y32 = y.float()
        ss = sh.enter(sh.sum((y32 * y32).sum(-1, keepdim=True), "ssm_inner"),
                      "ssm_inner")
        y = (y32 * torch.rsqrt(ss / di + 1e-6) * rep("norm")[ch].float()).to(dtype)
    else:
        y = rms_norm(y, p["norm"])
    return sh.sum(y @ p["out_proj"], "ssm_inner"), {"conv": new_conv_state,
                                                    "ssm": final_state}


def init_ssm_state(cfg, layers: int, batch: int, dtype, device,
                   heads: int | None = None) -> dict:
    """Conv and SSM states of ``layers`` layers, stacked on a leading axis;
    ``heads``: the SSM heads a rank holds (all by default; the conv state
    is whole on every rank)."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((layers, batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((layers, batch, heads or cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32, device=device),
    }
