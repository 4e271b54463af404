"""Sharding specifications for params, caches and activations (port of
``repro/models/sharding.py``).

Layout (DESIGN.md §6):
  * mesh axes: ("data", "model") single pod; ("pod", "data", "model") for
    multi-pod.  Batch shards over DP = ("pod","data"); tensor-parallel dims
    over "model".
  * attention: Q heads sharded over model when divisible (configs pad the
    head count, see ModelConfig.padded_num_heads); KV heads sharded only if
    num_kv_heads % model_size == 0, else replicated (GQA with few KV heads).
  * FFN: d_ff column/row parallel.  MoE: experts replicated in count,
    per-expert d_ff tensor-parallel ("TP-within-expert") so dispatch stays
    local to the data shard.
  * vocab: embedding + head sharded over model (configs pad vocab).
  * decode KV caches: sequence dimension sharded over model
    (cross-chip flash-decode); batch over DP when it divides.

A spec is a plain tuple with one entry per tensor dim, as
``jax.sharding.PartitionSpec`` holds them: an axis name, a tuple of axis
names, or None (replicated); a spec shorter than the tensor leaves the
trailing dims replicated.  The spec trees have the reference's structure
(the params' nested dicts, a list per stage).  ``to_shardings`` maps a
spec to ``DTensor`` placements over a ``DeviceMesh`` with the same axis
names (``repro_torch.launch.mesh.make_process_mesh``): the mesh dim named
at tensor dim i gets ``Shard(i)``, every other mesh dim ``Replicate()``.
``MeshPolicy`` redistributes an activation to its named spec, as
``with_sharding_constraint`` constrains it under GSPMD.

Under a mesh the model's params, its batch and its activations are
``DTensor``s and the model's code runs on them unchanged, with these
exceptions, each run on the local shards through
``torch.distributed.tensor.experimental.local_map`` (``_on_shards``
gives it each output's placements and each input's gradient placements):
  * ``rope_apply``: its angles are plain tensors of the positions; the
    rotation runs on the local batch rows and heads (``rope_on_shards``);
  * the plain attention (``chunked_attention``, ``blocked_attention``):
    its masks and running maxima are plain tensors and its grouped-head
    reshape splits a sharded head dim; it runs on the local heads, each
    local query head with its KV head (``attention_on_shards``);
  * ``causal_conv``: its zero state is a plain tensor; it runs on the
    local channels (``conv_on_shards``);
  * the scans (``linear_scan``, ``fused_selective_scan``): a Python loop
    of slices and concatenations along the sequence, elementwise in the
    sharded channels, whose zero state is a plain tensor; they run on the
    local rows and channels (``scan_on_shards``,
    ``fused_scan_on_shards``, which also keeps ``torch.utils.checkpoint``
    of each chunk on plain tensors);
  * the token embedding (``embed_on_shards``): the vocabulary-parallel
    lookup (each rank looks up the tokens in its rows, zeros elsewhere,
    summed over "model");
  * the MoE dispatch and combine (``moe_route``, the experts' gathers and
    scatters): they run on the local data shard, whose batch rows are the
    dispatch groups, the experts' d_ff on the local "model" shard
    (``moe_on_shards``); the router loss is formed from the routed counts
    and probabilities over the whole batch, as in the reference;
  * the loss's log-sum-exp and label gather: the logits are redistributed
    to ``Replicate()`` over "model" first (``unshard``).
No op is redistributed to ``Replicate()`` only to get round DTensor,
except the logits above.  ``torch.utils.checkpoint`` (``cfg.remat``) runs
on DTensors as it is.

The serving steps (``serving/steps.py``) run on a mesh over the
sequence-sharded KV cache of ``cache_specs`` (the sequence over "model",
over ("data", "model") where the batch does not divide "data"), the
flash-decode layout of the reference, with these escapes:
  * the flash kernel of a full-sequence step on the local rows and heads
    (``attention_on_shards``, as the plain attention);
  * the prefill's keys and values, gathered over their heads once, each
    rank keeping its sequence shard (``cache_from_prefill``);
  * the decode and chunked-prefill writes (``cache_write_on_shards``): the
    new tokens' K/V redistributed to the cache's rows, each rank writing
    in place the positions its shard holds and no others;
  * the attention of a decode step or a chunk over the cache
    (``decode_on_shards``, ``attend_on_sequence``): each rank, with every
    query head, attends over its shard (the decode kernel's range form,
    or the plain chunked attention) and returns the log-sum-exp beside
    its output; the shards' (o, lse) are all-gathered over the sequence's
    mesh axes and merged (``merge_shards``).  No step gathers or copies
    the cache.
The Mamba and RG-LRU decode states, the encoder-decoder's cross cache
and the int8 cache do not run on a mesh yet (``refuse_serving``).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .config import ATTN_KINDS, ModelConfig


def P(*entries):
    """A spec: the tuple of its entries, a one-name tuple entry read as the
    name (as ``PartitionSpec(*entries)`` reads it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    return fn(tree)


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _dp(mesh, size: int):
    """Batch axis spec: shard over DP only when it divides evenly."""
    axes = dp_axes(mesh)
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return axes if size % total == 0 else None


class MeshPolicy:
    """Activation-sharding policy bound to a mesh (see layers.NullPolicy).

    The "moe_gathered" and "moe_hidden" specs and the
    ``moe_gathered_spec == "auto"`` escape are the reference's; on the
    port's mesh path no call reaches them, since the MoE dispatch runs on
    the local shards (``moe_on_shards``) without a policy."""

    def __init__(self, mesh, cfg: ModelConfig, batch: int):
        self.mesh = mesh
        self.cfg = cfg
        self.msize = mesh.shape["model"]
        self.dp = _dp(mesh, batch)
        self.dp_size = 1
        if self.dp is not None:
            for a in self.dp:
                self.dp_size *= mesh.shape[a]
        h_ok = cfg.padded_num_heads % self.msize == 0
        kv_ok = cfg.num_kv_heads % self.msize == 0
        di_ok = (cfg.d_inner % self.msize == 0) if cfg.d_inner else False
        specs = {
            "act": P(self.dp, None, None),
            "act_q": P(self.dp, None, "model" if h_ok else None, None),
            "act_q_decode": P(self.dp, None, None, None),
            "act_kv": P(self.dp, None, "model" if kv_ok else None, None),
            "act_ff": P(self.dp, None, "model"),
            "logits": P(self.dp, None, "model"),
            "moe_gathered": P(self.dp, None, None, None),
            "moe_hidden": P(self.dp, None, None, "model"),
            "act_inner": P(self.dp, None, "model" if di_ok else None),
            "act_inner2": P(self.dp, None, "model" if di_ok else None),
            "ssm_conv": P(self.dp, None, "model" if di_ok else None),
            "ssm_state": P(self.dp, "model" if di_ok else None),
            # decode KV cache: sequence over model (flash-decode layout);
            # when the batch cannot use the data axis (long_500k, B=1) the
            # sequence dim absorbs it too.
            "kv_cache": P(self.dp,
                          ("data", "model") if self.dp is None else "model",
                          None, None),
        }
        self.specs = specs

    def __call__(self, x, name: str):
        if (name in ("moe_gathered", "moe_hidden")
                and self.cfg.moe_gathered_spec == "auto"):
            return x                      # let the ops place dispatch tensors
        spec = self.specs.get(name)
        if spec is None:
            return x
        # ssm_state for mamba is (B, di, state): adjust rank
        if name == "ssm_state" and x.ndim == 3:
            spec = P(*spec, None)
        if len(spec) != x.ndim:
            return x
        return constrain(x, self.mesh, spec)


# --------------------------------------------------------------------------
# parameter specs (mirror init_params structure)
# --------------------------------------------------------------------------
def _layer_specs(cfg: ModelConfig, kind: str, msize: int, cross: bool):
    h_ok = cfg.padded_num_heads % msize == 0
    kv_ok = cfg.num_kv_heads % msize == 0
    di_ok = (cfg.d_inner % msize == 0) if cfg.d_inner else False
    H = "model" if h_ok else None
    KV = "model" if kv_ok else None
    DI = "model" if di_ok else None

    def norm_spec():
        if cfg.norm == "rmsnorm":
            return {"scale": P(None)}
        if cfg.norm == "layernorm":
            return {"scale": P(None), "bias": P(None)}
        return {}

    def attn_spec():
        s = {"wq": P(None, H, None), "wk": P(None, KV, None),
             "wv": P(None, KV, None), "wo": P(H, None, None)}
        if cfg.qkv_bias and not cross:
            s.update({"bq": P(H, None), "bk": P(KV, None), "bv": P(KV, None)})
        if cfg.qk_norm:
            s.update({"q_norm": P(None), "k_norm": P(None)})
        return s

    def xattn_spec():
        return {"wq": P(None, H, None), "wk": P(None, KV, None),
                "wv": P(None, KV, None), "wo": P(H, None, None)}

    def ffn_spec():
        s = {"w1": P(None, "model"), "w2": P("model", None)}
        if cfg.glu:
            s["w3"] = P(None, "model")
        return s

    p = {"ln1": norm_spec()}
    if kind in ATTN_KINDS:
        p["attn"] = attn_spec()
        if cross:
            p["ln_x"] = norm_spec()
            p["xattn"] = xattn_spec()
        p["ln2"] = norm_spec()
        if cfg.num_experts:
            moe = {"router": P(None, None),
                   "w1": P(None, None, "model"), "w2": P(None, "model", None)}
            if cfg.glu:
                moe["w3"] = P(None, None, "model")
            if cfg.num_shared_experts:
                moe["shared"] = ffn_spec()
            p["moe"] = moe
        else:
            p["ffn"] = ffn_spec()
    elif kind == "rec":
        p["rec"] = {"w_x": P(None, DI), "w_gate": P(None, DI),
                    "conv_w": P(None, DI), "conv_b": P(DI),
                    "rg_a": P(DI, None, None), "rg_a_b": P(DI),
                    "rg_x": P(DI, None, None), "rg_x_b": P(DI),
                    "lam": P(DI), "out_proj": P(DI, None)}
        p["ln2"] = norm_spec()
        p["ffn"] = ffn_spec()
    elif kind == "mamba":
        p["mamba"] = {"in_proj": P(None, DI), "conv_w": P(None, DI),
                      "conv_b": P(DI), "x_proj": P(DI, None),
                      "dt_proj": P(None, DI), "dt_bias": P(DI),
                      "A_log": P(DI, None), "D": P(DI),
                      "out_proj": P(DI, None)}
    return p


def _prepend(spec_tree, axis_spec=None):
    """Prepend a leading (stacked-repeats) dim to every spec."""
    return _map_specs(lambda s: P(axis_spec, *s), spec_tree)


def param_specs(cfg: ModelConfig, mesh):
    msize = mesh.shape["model"]

    def norm_spec():
        if cfg.norm == "layernorm":
            return {"scale": P(None), "bias": P(None)}
        return {"scale": P(None)} if cfg.norm == "rmsnorm" else {}

    specs = {
        "embed": P("model", None),
        "final_norm": norm_spec(),
        "stages": [
            _prepend({f"b{j}": _layer_specs(cfg, kind, msize,
                                            cfg.is_encoder_decoder)
                      for j, kind in enumerate(pat)})
            for pat, reps in cfg.stages()
        ],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model")
    if cfg.is_encoder_decoder:
        specs["encoder"] = {
            "stages": [
                _prepend({f"b{j}": _layer_specs(cfg, kind, msize, False)
                          for j, kind in enumerate(pat)})
                for pat, reps in cfg.encoder_stages()
            ],
            "final_norm": norm_spec(),
        }
    return specs


def cache_specs(cfg: ModelConfig, mesh, batch: int):
    """Specs matching init_cache structure (stacked leading dim)."""
    dp = _dp(mesh, batch)
    msize = mesh.shape["model"]
    di_ok = (cfg.d_inner % msize == 0) if cfg.d_inner else False
    DI = "model" if di_ok else None
    seq_ax = ("data", "model") if dp is None else "model"

    def layer_cache_spec(kind):
        c = {}
        if kind in ATTN_KINDS:
            c["attn"] = {"k": P(None, dp, seq_ax, None, None),
                         "v": P(None, dp, seq_ax, None, None)}
            if cfg.kv_quant == "int8":
                c["attn"]["k_scale"] = P(None, dp, seq_ax, None, None)
                c["attn"]["v_scale"] = P(None, dp, seq_ax, None, None)
            if cfg.is_encoder_decoder:
                c["xattn"] = {"k": P(None, dp, None, None, None),
                              "v": P(None, dp, None, None, None)}
        elif kind == "rec":
            c["rec"] = {"conv": P(None, dp, None, DI),
                        "h": P(None, dp, DI)}
        elif kind == "mamba":
            c["mamba"] = {"conv": P(None, dp, None, DI),
                          "ssm": P(None, dp, DI, None)}
        return c

    return [
        {f"b{j}": layer_cache_spec(kind) for j, kind in enumerate(pat)}
        for pat, reps in cfg.stages()
    ]


def batch_specs(cfg: ModelConfig, mesh, batch: int, kind: str):
    """Specs for the input batch dict."""
    dp = _dp(mesh, batch)
    specs = {"tokens": P(dp, None)}
    if kind == "train":
        specs["labels"] = P(dp, None)
    if cfg.is_encoder_decoder:
        specs["frames"] = P(dp, None, None)
    if cfg.frontend == "vision" and kind in ("train", "prefill"):
        specs["patches"] = P(dp, None, None)
    return specs


# --------------------------------------------------------------------------
# specs -> DTensor placements; trees onto and off the mesh
# --------------------------------------------------------------------------
def placements(mesh, spec, ndim: int):
    """The ``DTensor`` placements of ``spec`` for a tensor of ``ndim``
    dims: ``Shard(i)`` on the mesh dim named at tensor dim i (alone or in
    a tuple of names, which then shard dim i in mesh order), else
    ``Replicate()``."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    out = []
    for name in mesh.axis_names:
        p = Replicate()
        for i, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if name in names:
                p = Shard(i)
        out.append(p)
    return tuple(out)


def to_shardings(mesh, spec_tree):
    """A spec tree as a tree of placement tuples (``placements`` of each
    spec, its rank read from the spec; ``put`` pads a shorter spec to the
    tensor's rank)."""
    return _map_specs(lambda s: placements(mesh, s, len(s)), spec_tree)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``places`` in the forward, and the gradient to the
    same ``places`` in the backward: ``with_sharding_constraint``'s
    transpose constrains the cotangent alike.  Without it DTensor hands a
    replicated activation's gradient back as a partial sum, and the
    weight gradients behind it come out unreduced and whole on every
    rank."""

    @staticmethod
    def forward(ctx, x, dmesh, places):
        ctx.dmesh, ctx.places = dmesh, places
        if tuple(x.placements) == places:
            return x.view_as(x)
        return x.redistribute(dmesh, places)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.places:
            g = g.redistribute(ctx.dmesh, ctx.places)
        return g, None, None


def constrain(x, mesh, spec):
    """``x`` redistributed to ``spec`` over ``mesh`` (a plain tensor is
    taken as replicated), its gradient likewise."""
    dm = mesh.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    return _Constrain.apply(x, dm, placements(mesh, spec, x.ndim))


def _local_slice(t: torch.Tensor, dmesh, places):
    """This rank's shard of the full tensor ``t`` (a copy, so the full
    tensor can be freed): chunks in mesh-dim order, as DTensor lays
    shards out."""
    coord = dmesh.get_coordinate()
    for mdim, p in enumerate(places):
        if isinstance(p, Shard):
            t = torch.chunk(t, dmesh.size(mdim), dim=p.dim)[coord[mdim]]
    return t.clone(memory_format=torch.contiguous_format)


def _contiguous_stride(shape):
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def put_leaf(t: torch.Tensor, mesh, spec):
    """A full tensor, held alike on every rank, as a ``DTensor`` over
    ``mesh`` placed by ``spec``: each rank keeps its own shard, no
    communication.  A ``DTensor`` is redistributed to ``spec``.  A 0-d
    leaf (the optimizer's step) stays a plain tensor, which every rank
    holds."""
    if t.ndim == 0:
        return t
    dm = mesh.device_mesh
    places = placements(mesh, spec, t.ndim)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == places else t.redistribute(
            dm, places)
    for mdim, p in enumerate(places):
        if isinstance(p, Shard) and t.shape[p.dim] % dm.size(mdim):
            raise ValueError(f"put: dim {p.dim} of {tuple(t.shape)} does "
                             f"not divide over the mesh {mesh.shape}")
    return DTensor.from_local(_local_slice(t, dm, places), dm, places,
                              run_check=False, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def put(tree, mesh, spec_tree):
    """A tree of full tensors onto ``mesh`` by ``spec_tree`` (``put_leaf``
    of each leaf; the specs' tree is the reference's, whose empty norm
    dicts match empty params)."""
    return map_specs(lambda t, s: put_leaf(t, mesh, s), tree, spec_tree)


def map_specs(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_specs(fn, v, s) for v, s in zip(tree, spec_tree)]
    return fn(tree, spec_tree)


def full(x):
    """The full tensor of a ``DTensor`` (a gather over the mesh, every
    rank takes part); a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def gather(tree):
    """A tree of ``DTensor``s as full tensors on every rank."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gather(v) for v in tree]
    return full(tree)


def flat_specs(spec_tree, prefix=""):
    """{"a/b/0/c": spec}: the spec tree under the checkpoint's flattened
    key paths (``training/checkpoint.py``)."""
    out = {}
    if isinstance(spec_tree, dict):
        for k, v in spec_tree.items():
            out.update(flat_specs(v, f"{prefix}{k}/"))
    elif isinstance(spec_tree, list):
        for i, v in enumerate(spec_tree):
            out.update(flat_specs(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = spec_tree
    return out


def placer(mesh, spec_tree, device):
    """``place(key, tensor)`` for ``load_checkpoint``: each leaf read from
    a checkpoint goes to ``device`` and onto ``mesh`` by the spec under its
    key path, one leaf at a time."""
    specs = flat_specs(spec_tree)

    def place(key, t):
        return put_leaf(t.to(device), mesh, specs[key])
    return place


# --------------------------------------------------------------------------
# ops run on the local shards (the escapes named in the docstring)
# --------------------------------------------------------------------------
def _grad_placements(places, out_places):
    """Where an input is replicated over a mesh dim on which an output is
    sharded or partial, each rank's local gradient is its part of the sum:
    ``Partial()`` there; elsewhere the input's own placement."""
    out = []
    for mdim, p in enumerate(places):
        spread = any(not isinstance(o[mdim], Replicate) for o in out_places)
        out.append(Partial() if isinstance(p, Replicate) and spread else p)
    return tuple(out)


def _on_shards(fn, args, out_places):
    """``local_map`` of ``fn`` over ``args`` (``DTensor``s as they are
    placed; None and plain tensors as they are): its outputs, a tensor or
    a tuple, become ``DTensor``s of ``out_places`` (one placement tuple an
    output), and each input's gradient is placed by ``_grad_placements``."""
    outs = [tuple(o) for o in out_places]
    grads = tuple(_grad_placements(a.placements, outs)
                  if isinstance(a, DTensor) else None
                  for a in args if a is not None)
    # one output's placements go as a list: a tuple means one an output
    return local_map(fn, out_placements=(tuple(outs) if len(outs) > 1
                                         else list(outs[0])),
                     in_grad_placements=grads)(*args)


def unshard(x, dim: int):
    """``x`` with its ``dim`` replicated over every mesh dim that shards
    it (the logits before the loss)."""
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def _batch_like(t, ref):
    """A plain tensor whose dim 0 is ``ref``'s (full on every rank) as a
    ``DTensor`` placed like ``ref``'s dim 0."""
    places = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in ref.placements)
    t = t.contiguous()
    return DTensor.from_local(_local_slice(t, ref.device_mesh, places),
                              ref.device_mesh, places, run_check=False,
                              shape=t.shape, stride=t.stride())


def _rows(x):
    """x's placements kept on its dim 0 (the batch rows), replicated
    elsewhere."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)


def rope_on_shards(fn, x, positions):
    """``fn(x, positions)`` (rope) on the local rows and heads of x: (B, S,
    H, hd); positions (B, S) or (S,), a plain tensor or a ``DTensor``."""
    if not isinstance(positions, DTensor):
        if positions.dim() == 1:
            positions = positions.expand(x.shape[0], -1)
        positions = _batch_like(positions, x)
    if tuple(positions.placements) != _rows(x):
        positions = positions.redistribute(x.device_mesh, _rows(x))
    return _on_shards(fn, (x, positions), [x.placements])


def attention_on_shards(fn, q, k, v):
    """``fn(q, k, v)`` (the plain attention) on the local batch rows and
    heads.  q: (B, S, H, hd), k, v: (B, Sk, KH, hd), each placed by rows
    (dim 0) and heads (dim 2).  Where the query heads are sharded over a
    mesh dim and the KV heads are not, each local query head attends with
    its own KV head (``h // (H // KH)``): the local call has one KV head
    per query head."""
    dm = q.device_mesh
    qp = tuple(q.placements)
    kp, select, m = [], False, 0
    for i, p in enumerate(qp):
        if not (isinstance(p, Replicate)
                or (isinstance(p, Shard) and p.dim in (0, 2))):
            raise ValueError(f"attention: query placed {qp}")
        if isinstance(p, Shard) and p.dim == 2:
            kpi = k.placements[i]
            if isinstance(kpi, Shard) and kpi.dim == 2:
                kp.append(kpi)
            else:
                kp.append(Replicate())
                select, m = True, dm.get_local_rank(i)
        else:
            kp.append(p)
    kp = tuple(kp)
    if tuple(k.placements) != kp:
        k = k.redistribute(dm, kp)
    if tuple(v.placements) != kp:
        v = v.redistribute(dm, kp)
    G = q.shape[2] // k.shape[2]

    def local(ql, kl, vl):
        if select:
            h = ql.shape[2]
            idx = (m * h + torch.arange(h, device=ql.device)) // G
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return fn(ql, kl, vl)
    return _on_shards(local, (q, k, v), [qp])


def conv_on_shards(fn, x, w, b):
    """``fn(x, w, b)`` (``causal_conv`` without a state) on the local rows
    and channels: x (B, S, C) takes w's (cw, C) channel placement."""
    dm = x.device_mesh
    want = tuple(Shard(2) if isinstance(wp, Shard) else
                 (xp if isinstance(xp, Shard) and xp.dim == 0
                  else Replicate())
                 for xp, wp in zip(x.placements, w.placements))
    if tuple(x.placements) != want:
        x = x.redistribute(dm, want)
    return _on_shards(fn, (x, w, b), [want])


def embed_on_shards(table, tokens):
    """The vocabulary-parallel lookup: table (V, d) over "model" by rows,
    tokens (B, S) over the data axis; each rank takes the rows it holds
    and zeros for the others, and the result is ``Partial()`` (summed)
    over the table's axis.  Tokens are already reduced into [0, V)."""
    dm = table.device_mesh
    tp = tuple(table.placements)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, dm, [Replicate()] * dm.ndim,
                                    run_check=False)
    kp = tuple(tokens.placements)
    out = []
    row_dims = [i for i, p in enumerate(tp) if isinstance(p, Shard)
                and p.dim == 0]
    for i in range(dm.ndim):
        if i in row_dims:
            out.append(Partial())
        elif isinstance(kp[i], Shard) and kp[i].dim == 0:
            out.append(Shard(0))
        else:
            out.append(Replicate())
    coord = dm.get_coordinate()
    n_rows = table.to_local().shape[0]
    lo = 0
    for i in row_dims:          # one table axis in the specs
        lo = coord[i] * n_rows

    def local(tab, tok):
        idx = tok - lo
        inside = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(inside[..., None], rows, rows.new_zeros(()))
    return _on_shards(local, (table, tokens), [tuple(out)])


def _drop_dim(places, dim: int):
    """Placements of a tensor with ``dim`` removed."""
    return tuple(Shard(p.dim - (p.dim > dim)) if isinstance(p, Shard)
                 else p for p in places)


def scan_on_shards(fn, a, b, h0):
    """``fn(a, b, h0)`` (``linear_scan``) on the local shards: the scan
    runs along dim 1, which no spec shards, and is elementwise in every
    other dim.  Returns (h_all placed as a, h_last placed as a without
    dim 1)."""
    places = tuple(a.placements)
    if tuple(b.placements) != places:
        b = b.redistribute(a.device_mesh, places)
    last = _drop_dim(places, 1)
    if h0 is not None and tuple(h0.placements) != last:
        h0 = h0.redistribute(a.device_mesh, last)
    return _on_shards(fn, (a, b, h0), [places, last])


def fused_scan_on_shards(fn, x_c, dt, Bm, Cm, A_log, D, h0):
    """``fn(x_c, dt, Bm, Cm, A_log, D, h0)`` (``fused_selective_scan``)
    on the local rows and channels: x_c, dt (B, S, di), A_log (di, N) and
    D (di,) by channel; Bm, Cm (B, S, N) by rows only.  Returns (y placed
    as x_c, h_last (B, di, N))."""
    dm = x_c.device_mesh
    xp = tuple(x_c.placements)
    chan = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 2
                 else Replicate() for p in xp)
    rows = _rows(x_c)
    dt = dt.redistribute(dm, xp)
    Bm, Cm = Bm.redistribute(dm, rows), Cm.redistribute(dm, rows)
    A_log, D = A_log.redistribute(dm, chan), D.redistribute(dm, chan)
    last = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
                 for p in xp)
    if h0 is not None:
        h0 = h0.redistribute(dm, last)
    return _on_shards(fn, (x_c, dt, Bm, Cm, A_log, D, h0), [xp, last])


def moe_on_shards(route_fn, experts_fn, x, router, weights):
    """The MoE FFN's dispatch on the local data shard: ``route_fn(x,
    router)`` on the local rows returns the groups' routing (its tensors
    placed like x's rows, replicated over "model"); ``experts_fn(x,
    route, weights)`` runs the experts on the local d_ff shard and returns
    each token's output, ``Partial()`` over "model" (summed by the
    caller's ``act`` constraint).  x: (B, S, d) over the data axis,
    replicated over "model"."""
    dm = x.device_mesh
    rows = _rows(x)
    if tuple(x.placements) != rows:
        x = x.redistribute(dm, rows)
    router = router.redistribute(dm, [Replicate()] * dm.ndim)
    keys = ("probs", "counts", "table", "wtab", "slot")
    def route_local(xl, rl):
        r = route_fn(xl, rl)                  # once: the tuple takes its keys
        return tuple(r[k] for k in keys)
    r = _on_shards(route_local, (x, router), [rows] * len(keys))
    route = dict(zip(keys, r))
    wdims = [w.placements for w in weights]
    partial = tuple(Partial() if any(isinstance(wp[i], Shard) for wp in wdims)
                    else rows[i] for i in range(dm.ndim))
    y = _on_shards(lambda xl, tab, wt, sl, *ws: experts_fn(
        xl, {"table": tab, "wtab": wt, "slot": sl}, ws),
        (x, route["table"], route["wtab"], route["slot"], *weights),
        [partial])
    return y, route


# --------------------------------------------------------------------------
# serving on a mesh: the sequence-sharded KV cache
# --------------------------------------------------------------------------
def refuse_serving(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for the caches the serving steps do
    not run on a mesh yet (``ROADMAP.md``, A.12): the Mamba and RG-LRU
    decode states, the encoder-decoder's cross cache, the int8 cache."""
    kinds = {k for pattern, _ in cfg.stages() for k in pattern}
    missing = [what for cond, what in (
        ("mamba" in kinds, "the Mamba decode state"),
        ("rec" in kinds, "the RG-LRU decode state"),
        (cfg.is_encoder_decoder, "the encoder-decoder's cross cache"),
        (cfg.kv_quant == "int8", "the int8 KV cache")) if cond]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the serving steps do not run {', '.join(missing)} "
            "on a mesh yet (see ROADMAP.md, A.12)")


def _chunk_of(places, dmesh, dim: int):
    """(index, count): this rank's chunk of tensor dim ``dim`` among the
    chunks the mesh dims that shard it cut, in mesh order (as DTensor
    lays them out)."""
    coord = dmesh.get_coordinate()
    idx, n = 0, 1
    for mdim, p in enumerate(places):
        if isinstance(p, Shard) and p.dim == dim:
            idx, n = idx * dmesh.size(mdim) + coord[mdim], n * dmesh.size(mdim)
    return idx, n


def zeros(shape, dtype, mesh, spec, device):
    """A zero ``DTensor`` of ``shape`` placed by ``spec``: each rank makes
    its own shard, the full tensor exists nowhere."""
    dm = mesh.device_mesh
    places = placements(mesh, spec, len(shape))
    local = list(shape)
    for mdim, p in enumerate(places):
        if isinstance(p, Shard):
            if local[p.dim] % dm.size(mdim):
                raise ValueError(f"zeros: dim {p.dim} of {tuple(shape)} does "
                                 f"not divide over the mesh {mesh.shape}")
            local[p.dim] //= dm.size(mdim)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), dm, places,
        run_check=False, shape=torch.Size(shape),
        stride=_contiguous_stride(shape))


def cache_from_prefill(t, mesh, spec, cache_len: int):
    """A prompt's keys or values t: (B, S, KH, hd) as a layer's cache leaf
    of ``cache_len`` positions placed by ``spec`` (the policy's
    "kv_cache": rows over the data axes, the sequence over the rest).  t
    is gathered to its rows' placement once (its heads over "model"), and
    each rank keeps the prompt's positions that fall in its sequence
    shard, zeros past them."""
    dm = mesh.device_mesh
    places = placements(mesh, spec, 4)
    if tuple(t.placements) != _rows(t):
        t = t.redistribute(dm, _rows(t))
    tl = t.to_local()
    seq, n = _chunk_of(places, dm, 1)
    if cache_len % n:
        raise ValueError(f"cache of {cache_len} positions over {n} shards")
    Ll = cache_len // n
    s0 = seq * Ll
    local = tl.new_zeros((tl.shape[0], Ll, *tl.shape[2:]))
    m = max(0, min(Ll, tl.shape[1] - s0))
    local[:, :m] = tl[:, s0:s0 + m]
    shape = (t.shape[0], cache_len, *t.shape[2:])
    return DTensor.from_local(local, dm, places, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _row_slice(places, dmesh, n_local: int):
    idx, _ = _chunk_of(places, dmesh, 0)
    return slice(idx * n_local, (idx + 1) * n_local)


def cache_write_on_shards(cache, new, positions):
    """Write ``new`` (B, C, KH, hd) into the cache leaf (B, L, KH, hd) at
    the global ``positions`` (B, C) (a plain tensor, the same on every
    rank), in place: ``new`` is redistributed to the cache's rows
    (replicated over the sequence axes: C tokens a row), and each rank
    writes into its local shard the positions it holds and no others,
    positions past the cache dropped.  No rank reads or copies the rest of
    the cache."""
    dm = cache.device_mesh
    cp = tuple(cache.placements)
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in cp)
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, dm, [Replicate()] * dm.ndim,
                                 run_check=False)
    if tuple(new.placements) != rows:
        new = new.redistribute(dm, rows)
    loc, nl = cache.to_local(), new.to_local().to(cache.dtype)
    Bl, Ll = loc.shape[:2]
    seq, _ = _chunk_of(cp, dm, 1)
    at = positions[_row_slice(cp, dm, Bl)].long() - seq * Ll
    r = torch.arange(Bl, device=loc.device)[:, None].expand_as(at)
    if at.shape[1] == 1:
        # one token a row: where it falls outside the shard the row's
        # clamped position is written back as it was (no host sync)
        atc = at.clamp(0, Ll - 1)
        keep = ((at >= 0) & (at < Ll))[..., None, None]
        loc[r, atc] = torch.where(keep, nl, loc[r, atc])
    else:
        keep = (at >= 0) & (at < Ll)
        loc[r[keep], at[keep]] = nl[keep]
    return cache


def merge_shards(outs, lses):
    """The attention over sequence shards from each shard's o (..., hd)
    and lse (...) f32: m = max lse, w = exp(lse - m), o = sum w o / sum w;
    a shard with no valid key (lse -inf) weighs 0.  Returns (o in the
    shards' dtype, lse f32)."""
    lse = torch.stack([x.reshape(outs[0].shape[:-1]) for x in lses])
    m = lse.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=m.device))
    w = torch.exp(lse - m)
    num = sum(o.float() * wi[..., None] for o, wi in zip(outs, w))
    den = w.sum(dim=0)
    out = num / den[..., None].clamp_min(1e-37)
    return (out.to(outs[0].dtype),
            (m + torch.log(den)).reshape(lses[0].shape))


def _merge_shards(o, lse, dmesh, dims):
    """``merge_shards`` across the ranks of the sequence's mesh dims
    ``dims``: each rank's (o, lse), gathered over each of them in turn
    (one all-gather a mesh dim), merged alike on every rank.  With one
    shard o is returned as it is."""
    groups = [dmesh.get_group(i) for i in dims if dmesh.size(i) > 1]
    if not groups:
        return o
    import torch.distributed as dist
    buf = torch.cat([o.float().flatten(), lse.flatten()])
    for g in groups:
        out = buf.new_empty(dist.get_world_size(g) * buf.numel())
        dist.all_gather_into_tensor(out, buf, group=g)
        buf = out
    parts = buf.view(-1, o.numel() + lse.numel()).split(
        (o.numel(), lse.numel()), dim=1)
    merged, _ = merge_shards([x.view(o.shape) for x in parts[0]],
                             [x.view(lse.shape) for x in parts[1]])
    return merged.to(o.dtype)


def attend_on_sequence(fn, q, k, v, q_pos):
    """Queries q: (B, C, H, hd) (row b's first at global position
    ``q_pos[b]``, a plain (B,) tensor) against the sequence-sharded cache
    k, v: (B, L, KH, hd): q is redistributed to the cache's rows with
    every head, each rank calls ``fn(ql, kl, vl, q_pos_local, k_offset)``
    -> (o, lse) on its rows and shard (``k_offset`` its shard's first
    position), and the shards are merged over the sequence's mesh dims.
    Returns o (B, C, H, hd) placed by the cache's rows.  Chunked prefill
    passes the plain chunked attention with its log-sum-exp."""
    dm = k.device_mesh
    kp = tuple(k.placements)
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in kp)
    if tuple(q.placements) != rows:
        q = q.redistribute(dm, rows)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    Bl, Ll = kl.shape[:2]
    seq, _ = _chunk_of(kp, dm, 1)
    o, lse = fn(ql, kl, vl, q_pos[_row_slice(kp, dm, Bl)], seq * Ll)
    o = _merge_shards(o, lse.view(o.shape[:-1]), dm,
                      [i for i, p in enumerate(kp)
                       if isinstance(p, Shard) and p.dim == 1])
    return DTensor.from_local(o, dm, rows, run_check=False, shape=q.shape,
                              stride=_contiguous_stride(q.shape))


def decode_on_shards(fn, q, k, v, pos, window: int):
    """One query token a row against the sequence-sharded cache: each rank
    calls ``fn(ql, kl, vl, lo, hi, window=window)`` (the decode kernel's
    range form, returning (o, lse)) on its rows and shard, with each row's
    global range [max(0, pos - window + 1), pos] cut to the shard in the
    shard's positions (empty where it misses the shard), and the shards
    are merged.  q: (B, 1, H, hd) with every query head; pos (B,) int32,
    a plain tensor.  Returns o (B, 1, H, hd) placed by the cache's rows."""
    from repro_torch.kernels.decode_attention.ref import valid_range

    def local(ql, kl, vl, p, k0):
        lo, hi = valid_range(p - k0, ql.shape[0], window, ql.device)
        return fn(ql, kl, vl, lo, hi, window=window)
    return attend_on_sequence(local, q, k, v, pos)
