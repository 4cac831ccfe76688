"""Ring attention: sequence parallelism over the ``seq`` mesh axis.

Port of ``nnstreamer_tpu/parallel/ring.py``.  Blockwise attention with
an online (flash-style) softmax: every slot of the ``seq`` axis keeps its
resident Q shard while the K/V shards rotate around the ring, one hop a
step, and each step's block is merged into float32 running statistics
(the JAX package's merge, its guards for fully masked rows included).
The JAX ring computes its block product with ``einsum``, not in a Pallas
kernel, so the block product here is plain torch.

Where the JAX package's per-device body runs under ``shard_map`` (one
call per device, ``lax.ppermute`` between them), the port's
:func:`ring_attention_local` is the per-PROCESS body: it takes the
shards of the process's consecutive ring positions and steps them
together.  A hop between two slots of the process is a tensor copy to
the next slot's device (none where they share one); a hop across ranks
is a ``batch_isend_irecv`` on the process group (gloo: staged through
host memory).

Shapes: q/k/v shards ``[B, T_local, H, D]``; the global sequence is
``T_local * seq`` positions, causal masking by global position.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch


def _block_attn(q, k, v, mask, scale):
    """One (q-shard x kv-block) attention piece with stable running stats:
    (o_unnorm [B, Tq, H, D], m [B, H, Tq], l [B, H, Tq]), all float32.
    Scores are float32 products of the inputs; the probabilities enter
    the value product in ``v``'s dtype, as the JAX package's einsum with
    ``preferred_element_type=float32`` takes them."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)
    # a fully masked row (m = -inf): exp(0) = 1 rows, zeroed by the mask
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, l


def _merge(acc, blk):
    """The flash-attention combine of running stats ``acc`` and a block's
    ``blk`` (each ``(o, m, l)``); an -inf source contributes 0."""
    o_acc, m_acc, l_acc = acc
    o, m, l = blk
    m_new = torch.maximum(m_acc, m)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    zero = torch.zeros_like(m_new)
    a = torch.where(torch.isfinite(m_acc), torch.exp(m_acc - m_safe), zero)
    b = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
    l_new = l_acc * a + l * b
    o_new = o_acc * a.transpose(1, 2)[..., None] + o * b.transpose(1, 2)[..., None]
    return o_new, m_new, l_new


def _rotate(blocks: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each position's block to the next position of the ring: within the
    process a shift (copied where the next slot is on another device),
    the last one to the next rank and the previous rank's into the first
    (``batch_isend_irecv``, staged through host memory)."""
    if group is None:
        head = blocks[-1]
    else:
        import torch.distributed as dist

        rank, world = dist.get_rank(group), dist.get_world_size(group)
        # gloo's send and recv read and write host memory: a card block
        # goes through pinned memory both ways
        last = blocks[-1]
        out = torch.empty(last.shape, dtype=last.dtype, pin_memory=last.is_cuda)
        out.copy_(last)
        got = torch.empty_like(out)
        ops = [dist.P2POp(dist.isend, out, (rank + 1) % world, group),
               dist.P2POp(dist.irecv, got, (rank - 1) % world, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        head = got
    moved = [head] + blocks[:-1]
    return [t if t.device == d.device else t.to(d.device)
            for t, d in zip(moved, blocks)]


def ring_attention_local(q: Union[torch.Tensor, Sequence[torch.Tensor]], k, v, *,
                         index: int = 0, size: Optional[int] = None,
                         causal: bool = True, scale: Optional[float] = None,
                         group=None):
    """Ring attention over the process's ring positions ``index ..
    index + len(q) - 1`` of ``size`` (default: the process holds the whole
    ring).  ``q``/``k``/``v``: one shard each (a tensor) or a list, one per
    position, each on its slot's device; returns the output shards the
    same way.  ``group``: the process group when the ring spans ranks
    (every rank holds as many consecutive positions, in rank order).

    Each position starts on its own K/V block and takes the blocks in the
    JAX order, the chunk index counting down."""
    single = isinstance(q, torch.Tensor)
    qs, ks, vs = ([q], [k], [v]) if single else (list(q), list(k), list(v))
    n_local = len(qs)
    n = int(size) if size is not None else n_local
    B, Tl, H, D = qs[0].shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    mine = [index + j for j in range(n_local)]
    chunk = list(mine)
    acc = [(torch.zeros((B, Tl, H, D), dtype=torch.float32, device=t.device),
            torch.full((B, H, Tl), float("-inf"), device=t.device),
            torch.zeros((B, H, Tl), device=t.device)) for t in qs]
    ar = {}
    for step in range(n):
        for j in range(n_local):
            mask = None
            if causal:
                dev = qs[j].device
                if dev not in ar:
                    ar[dev] = torch.arange(Tl, device=dev)
                q_pos = mine[j] * Tl + ar[dev]
                k_pos = chunk[j] * Tl + ar[dev]
                mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
            acc[j] = _merge(acc[j], _block_attn(qs[j], ks[j], vs[j], mask, scale))
        if step + 1 < n:  # the last step's hop would go unused
            ks, vs = _rotate(ks, group), _rotate(vs, group)
            chunk = [(c - 1) % n for c in chunk]
    outs = []
    for (o, _, l), t in zip(acc, qs):
        l = torch.clamp(l, min=1e-20)
        outs.append((o / l.transpose(1, 2)[..., None]).to(t.dtype))
    return outs[0] if single else outs


def seq_slots(mesh):
    """The ring: the slots along ``seq`` (every other axis at 0), this
    process's among them, the first of those's ring index and the process
    group when the ring spans ranks."""
    from .distributed import group_of

    line = mesh.axis_line("seq")
    own = [i for i, s in enumerate(line) if s.addressable]
    if not own or own != list(range(own[0], own[0] + len(own))):
        raise ValueError(f"this process's ring positions {own} are not one run")
    return line, own, group_of(line)


def ring_attention(mesh, q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Host-level ring attention over ``mesh``'s ``seq`` axis.

    Inputs are global ``[B, T, H, D]`` values (host or device); each
    ring position gets its ``T / seq`` rows on its slot's device, and the
    output is the exact full attention result, whole on the first of this
    process's slots (gathered from every rank where the ring spans them),
    computed without any slot holding more than ``T / seq`` keys."""
    line, own, group = seq_slots(mesh)
    n = len(line)

    def cut(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if t.shape[1] % n:
            raise ValueError(f"sequence {t.shape[1]} does not divide over seq={n}")
        tl = t.shape[1] // n
        return [t[:, i * tl:(i + 1) * tl].to(line[i].device).contiguous() for i in own]

    outs = ring_attention_local(cut(q), cut(k), cut(v), index=own[0], size=n,
                                causal=causal, scale=scale, group=group)
    dev = line[own[0]].device
    local = torch.cat([o.to(dev) for o in outs], dim=1)
    if group is None:
        return local
    from .sharding import cross_rank_cat

    return cross_rank_cat(local, 1, group)
