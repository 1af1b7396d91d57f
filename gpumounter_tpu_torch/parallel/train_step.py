"""The probe's training step, on one device or sharded over a mesh (dp x tp
or dp x sp).

Counterpart of ``gpumounter_tpu/parallel/train_step.py``: ``param_specs``,
``shard_params``, ``sgd_update``, ``make_train_step`` and
``make_train_step_optim`` (the shape of ``make_train_step_optax``, over
``torch.optim``), plus ``gather_params``, which the reference has no need
of. Params are the probe's plain dict (``models.probe.init_params``);
gradients come from ``torch.autograd`` through ``models.probe.loss_fn``,
so on the card every block's attention runs the forward kernel with lse
and the two backward kernels.

dp x tp (the reference's "heads" layout over ("data", "model")): one
process per rank, each holding a ``parallel.mesh.Mesh`` and its shards.
The batch is split over "data"; ``wqkv`` and ``w1`` are split by columns
and ``wo`` and ``w2`` by rows over "model" (Megatron), an MoE block's
experts over "model", and the rest is replicated. GSPMD places the
reference's shards and derives its collectives; here ``models.probe``
states them (f and g, ``parallel.collectives``), every rank runs the
kernels on its own heads, and the gradients are averaged over "data".

The fused ``wqkv``'s spec is a ``parallel.mesh.HeadSplit``: the
reference's ``(None, "model")``, cut by heads (rank r holds its own q
heads' columns, then its k heads', then its v heads'). Every placement of
a leaf, here (``shard_params``, ``gather_params``) and in a checkpoint's
pack and restore (``torchside.resume``), goes through
``parallel.mesh.shard_leaf`` and ``gather_leaf`` on these specs.

dp x sp (the reference's "seq" layout over (data, seq), any axis names):
the params are whole on every rank, the batch is split over data, and each
rank runs its chunk of the positions over seq, attention through
``parallel.ring_attention``. ``models.probe.loss_fn`` gives each rank a
share of the loss (its positions' NLL over the whole batch's B·(L − 1),
and 1/(dp·sp) of its aux loss), so the shares sum to the reference's
global mean, and each rank's gradient is the gradient of the whole loss
through its own computation (the ring's shifts carry the other ranks'
cotangents back to the K/V chunks they used). The gradients of the
replicated params are summed over data and over seq, and so is the loss:
every rank ends with the reference's gradient of its global mean.
"""

from __future__ import annotations

import torch

from gpumounter_tpu_torch.models.probe import TransformerConfig, check_seq_split, loss_fn
from gpumounter_tpu_torch.ops.flash_attention import flash_attention
from gpumounter_tpu_torch.parallel.collectives import mean_over_data, sum_over
from gpumounter_tpu_torch.parallel.mesh import HeadSplit, gather_leaf, shard_batch, shard_leaf
from gpumounter_tpu_torch.parallel.moe import moe_param_specs


def _keys(node: dict) -> list:
    """A dict's keys in leaf order: its leaves' keys sorted, then those of
    its dicts and lists sorted."""
    return sorted(node, key=lambda k: (isinstance(node[k], (dict, list)), k))


def tree_leaves(params) -> list[torch.Tensor]:
    """The params' tensors in a fixed order: at each level of dicts the
    leaves' keys sorted, then the nested dicts and lists (the probe's
    blocks, the pipeline's stages) in key order, lists in order. For the
    probe: the top-level tensors sorted, then each block's keys sorted (the
    order of ``jax.tree.leaves`` within each level)."""
    if isinstance(params, list):
        return [leaf for item in params for leaf in tree_leaves(item)]
    if isinstance(params, dict):
        return [leaf for key in _keys(params) for leaf in tree_leaves(params[key])]
    return [params]


def tree_map(fn, params, *rest):
    """A params tree of fn(leaf, *matching leaves of rest)."""
    if isinstance(params, list):
        return [tree_map(fn, item, *(r[i] for r in rest)) for i, item in enumerate(params)]
    if isinstance(params, dict):
        return {key: tree_map(fn, params[key], *(r[key] for r in rest))
                for key in _keys(params)}
    return fn(params, *rest)


def tree_names(params, prefix: str = "") -> list[str]:
    """Names of ``tree_leaves(params)``, in its order: e.g. "embed",
    "blocks[0].wqkv", "stages.w1"."""
    if isinstance(params, list):
        return [n for i, item in enumerate(params) for n in tree_names(item, f"{prefix}[{i}]")]
    if isinstance(params, dict):
        return [n for key in _keys(params)
                for n in tree_names(params[key], f"{prefix}.{key}" if prefix else key)]
    return [prefix]


def param_specs(cfg: TransformerConfig) -> dict:
    """The reference's PartitionSpecs as tuples, one entry per dim: the
    mesh axis a dim is split over, or None. Dense blocks: wqkv and w1
    split by columns (the output dim), wo and w2 by rows (the input dim).
    MoE blocks: the stacked experts' expert dim over "model", the router
    replicated (``parallel.moe.moe_param_specs``). wqkv's spec is a
    ``HeadSplit``, equal to the reference's and cut by heads. In the seq
    layout every leaf is replicated: the parallelism lives in the
    activations."""
    block = {"wqkv": HeadSplit((None, "model"), cfg.n_heads, cfg.kv_heads, cfg.d_head),
             "wo": ("model", None), "ln1": (None,), "ln2": (None,)}
    if cfg.n_experts is None:
        block.update(w1=(None, "model"), w2=("model", None))
    else:
        block.update(moe_param_specs(axis="model"))
    specs = {"embed": (None, None), "blocks": [dict(block) for _ in range(cfg.n_layers)]}
    if not cfg.rope:  # rope configs carry no learned position table
        specs["pos"] = (None, None)
    if cfg.attn_parallel == "seq":
        specs = tree_map(lambda spec: (None,) * len(spec), specs)
    return specs


def shard_params(params: dict, mesh, cfg: TransformerConfig) -> dict:
    """This rank's shards of full params (``param_specs`` through
    ``shard_leaf``), as new tensors on the mesh's device (the full ones may
    live on the CPU, so that the device never holds them). Raises
    ValueError where a split is uneven: the heads, d_ff or the experts over
    "model". In the seq layout every leaf is a whole copy."""
    if cfg.attn_parallel != "seq" and mesh.axis_names[1] != "model":
        raise ValueError(f"the dp x tp layout shards over a 'model' axis, got "
                         f"{mesh.axis_names}")
    return tree_map(lambda leaf, spec: shard_leaf(leaf, spec, mesh), params, param_specs(cfg))


def gather_params(local: dict, mesh, cfg: TransformerConfig) -> dict:
    """The full params of which `local` holds this rank's shards
    (``shard_params``), on every rank of the model group, which must all
    call it together; for checks and checkpoints. In the seq layout every
    leaf is whole already."""
    return tree_map(lambda leaf, spec: gather_leaf(leaf, spec, mesh), local, param_specs(cfg))


def loss_and_grads(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                   attention=flash_attention, mesh=None) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of ``loss_fn``: the counterpart of
    ``jax.value_and_grad(loss_fn)``. grads has the params' layout and
    dtypes; params are left as they are.

    mesh: params are this rank's shards and tokens the whole batch; the
    rank runs its rows (and in the seq layout its chunk of positions). The
    loss is the whole batch's, and grads are this rank's shards of the
    whole batch's gradients (``_reduce_shares``)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    tokens = _rank_rows(tokens, cfg, mesh)
    loss = loss_fn(leaves, tokens, cfg, attention, mesh)
    grads = [g.contiguous() for g in torch.autograd.grad(loss, tree_leaves(leaves))]
    loss = _reduce_shares(grads, loss.detach().clone(), cfg, mesh)
    grads = iter(grads)
    return loss, tree_map(lambda _: next(grads), params)


def _rank_rows(tokens: torch.Tensor, cfg: TransformerConfig, mesh) -> torch.Tensor:
    """This rank's rows of the whole batch (the batch itself without a
    mesh), after the seq layout's check that the batch splits evenly."""
    if mesh is None:
        return tokens
    if cfg.attn_parallel == "seq":
        check_seq_split(tuple(tokens.shape), mesh)
    return shard_batch(tokens, mesh)


def _reduce_shares(grads: list, loss: torch.Tensor, cfg: TransformerConfig, mesh) -> torch.Tensor:
    """The whole batch's gradients and loss from this rank's shares, in
    place in `grads` (contiguous); returns the loss. heads: the mean over
    "data" (each rank's share is its rows' mean). seq: the sum over both
    axes (the shares sum to the loss)."""
    if mesh is None:
        return loss
    if cfg.attn_parallel == "seq":
        return sum_over(grads + [loss], mesh, mesh.axis_names)[-1]
    mean_over_data(grads, mesh)
    return mean_over_data([loss], mesh)[0]


@torch.no_grad()
def sgd_update(params: dict, grads: dict, lr: float) -> dict:
    """float32 SGD update cast back to each param's dtype, as new tensors."""
    return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                    params, grads)


def step_collectives(cfg: TransformerConfig, mesh, local: dict, batch: tuple) -> dict:
    """The collectives of one ``make_train_step`` step over `mesh`, on
    this rank's shards `local` and a whole batch of shape `batch` (B, T):
    {"calls": {axis: n}, "bytes": {axis: payload bytes}}.

    Over "model" (size > 1): 4 a block, each on an activation of this
    rank's rows (B/dp, T, d_model) in cfg.dtype: g after wo and after w2
    or the expert combine in the forward, f before wqkv and before w1 or
    the experts in the backward. Over "data" (size > 1): one gradient sum
    a leaf, of this rank's shard; the loss (4 bytes); and for MoE configs
    each block's routed fractions (E float32). No gather: no rank holds a
    whole leaf that is split over "model".

    The seq layout, over (data, seq) of sizes dp and sp: over seq (sp > 1),
    the ring's shifts, sp − 1 a block forward (this rank's k and v chunks,
    (B/dp, H_kv, T/sp, d_head) each in cfg.dtype) and as many backward (dk
    and dv, of the same size); over each axis of size > 1, one gradient sum
    a leaf (whole leaves), the loss (4 bytes) and for MoE configs each
    block's routed fractions (E float32).
    """
    if cfg.attn_parallel == "seq":
        return _seq_step_collectives(cfg, mesh, local, batch)
    data, model = mesh.axis_names
    rows, seq = batch[0] // mesh.size(data), batch[1]
    calls, nbytes = {data: 0, model: 0}, {data: 0, model: 0}
    if mesh.size(model) > 1:
        calls[model] = 4 * cfg.n_layers
        nbytes[model] = calls[model] * rows * seq * cfg.d_model * cfg.dtype.itemsize
    if mesh.size(data) > 1:
        leaves = tree_leaves(local)
        calls[data] = len(leaves) + 1
        nbytes[data] = sum(t.nbytes for t in leaves) + 4
        if cfg.n_experts is not None:
            calls[data] += cfg.n_layers
            nbytes[data] += cfg.n_layers * cfg.n_experts * 4
    return {"calls": calls, "bytes": nbytes}


def _seq_step_collectives(cfg: TransformerConfig, mesh, local: dict, batch: tuple) -> dict:
    data, seq = mesh.axis_names
    dp, sp = mesh.size(data), mesh.size(seq)
    calls, nbytes = {data: 0, seq: 0}, {data: 0, seq: 0}
    leaves = tree_leaves(local)
    for axis in (data, seq):
        if mesh.size(axis) > 1:
            calls[axis] = len(leaves) + 1
            nbytes[axis] = sum(t.nbytes for t in leaves) + 4
            if cfg.n_experts is not None:
                calls[axis] += cfg.n_layers
                nbytes[axis] += cfg.n_layers * cfg.n_experts * 4
    if sp > 1:
        kv = 2 * (batch[0] // dp) * cfg.kv_heads * (batch[1] // sp) * cfg.d_head
        shifts = 2 * (sp - 1) * cfg.n_layers
        calls[seq] += shifts
        nbytes[seq] += shifts * kv * cfg.dtype.itemsize
    return {"calls": calls, "bytes": nbytes}


def make_train_step(cfg: TransformerConfig, lr: float = 1e-3, mesh=None):
    """Returns step(params, tokens) -> (new params, loss).

    mesh: a ("data", "model") ``parallel.mesh.Mesh``; params are this
    rank's shards (``shard_params``) and tokens the whole batch, and the
    step returns this rank's new shards and the whole batch's loss. The
    f32 update is applied shard by shard. Its collectives are
    ``step_collectives``': for L blocks and n_leaves leaves, 4 L over
    "model" and n_leaves + 1 (+ L for MoE) over "data". With
    cfg.attn_parallel == "seq", a (data, seq) mesh: params whole on every
    rank, and 2 (sp − 1) L ring shifts over seq besides the sums.
    """

    def step(params, tokens):
        loss, grads = loss_and_grads(params, tokens, cfg, mesh=mesh)
        return sgd_update(params, grads, lr), loss

    return step


def make_train_step_optim(cfg: TransformerConfig, make_optimizer, mesh=None):
    """A train step driven by a ``torch.optim`` optimizer, in the shape of
    the reference's ``make_train_step_optax``. Returns (init_fn, step_fn):

        opt_state = init_fn(params)       # make_optimizer(tree_leaves(params))
        params, opt_state, loss = step_fn(params, opt_state, tokens)

    e.g. ``make_optimizer=lambda ps: torch.optim.AdamW(ps, lr=1e-3,
    weight_decay=1e-4)``, the counterpart of ``optax.adamw(1e-3,
    weight_decay=1e-4)``. torch.optim updates in place where optax returns
    new arrays: init_fn marks the params' tensors as requiring grad, and
    step_fn returns the same dict with its tensors updated.

    mesh: as in ``make_train_step``; each rank's gradients are averaged
    over "data" (summed over data and seq in the seq layout) before its
    optimizer steps. Each rank's optimizer holds
    only its own shards, so its state mirrors the parameter layout by
    construction: the reference refuses optimizer state that does not
    mirror the params (it would replicate it onto every device), and here
    there is nothing of the kind to refuse.
    """

    def init_fn(params):
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        return make_optimizer(leaves)

    def step_fn(params, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, _rank_rows(tokens, cfg, mesh), cfg, mesh=mesh)
        loss.backward()
        # .grad has its (contiguous) param's strides.
        loss = _reduce_shares([leaf.grad for leaf in tree_leaves(params)],
                              loss.detach().clone(), cfg, mesh)
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step_fn
