"""Train-time augmentation on the device (counterpart of
``immunostruct_tpu/data/device_augment.py``): the host pipeline's
transforms (``data/pipeline.py``) as tensor operations on the batch's
device, for the device-resident pipeline's SSL and augmented runs.

  - a random rotation of the coordinates from a normalized quaternion
    (data/utils.py:148-155 of the reference: a uniform rotation);
  - SSL single-residue masking: one random real residue's one-hot set to
    all-ones, its class returned (immmunopred_dataloader.py:104-115);
  - structure masking: ``count`` random node rows zeroed unless already
    SSL-masked (immmunopred_dataloader.py:92-102);
  - sequence masking: ``count`` random positions in the HLA region set to
    the 'J' one-hot (immmunopred_dataloader.py:78-89).

Each transform is a *core* that takes its random draws as tensors (the
normals, Gumbels or uniforms) and a wrapper that draws them from a
``torch.Generator`` on the batch's device; ``augment_batch`` and
``augment_comparative`` draw in a fixed order, so one generator seed gives
the same bits every time. The streams are not the host pipeline's (numpy)
nor the JAX package's (``jax.random``): an augmented device run is
statistically, not bitwise, the host run. Fed the JAX package's own draws,
the cores give its masks and classes bit for bit. Distinct positions come
from the top ``count`` of uniform draws (only the set matters). Nothing
leaves the device: no ``.item()``, no boolean-mask indexing, no
``nonzero``.
"""

from __future__ import annotations

from typing import Optional

import torch

from immunostruct_tpu_torch.structs import (
    ComparativeBatch, GraphBatch, SampleBatch,
)

_TINY = torch.finfo(torch.float32).tiny


# -- draws -------------------------------------------------------------------

def normals(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def uniforms(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def gumbels(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """-log(-log U) with U in [tiny, 1), as ``jax.random.gumbel`` keeps it:
    a draw of 0 would give an infinite score."""
    u = uniforms(gen, shape).clamp_(min=_TINY)
    return -torch.log(-torch.log(u))


# -- cores ---------------------------------------------------------------------

def rotations(q: torch.Tensor) -> torch.Tensor:
    """[B, 4] gaussian draws -> [B, 3, 3] rotations: a normalized 4D
    gaussian is a uniform quaternion, so the rotation is uniform on SO(3)."""
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True))
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[0], 3, 3)


def rotate_coords(coords: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] coordinates times the rotations of the draws ``q``."""
    return torch.einsum("bnc,bcd->bnd", coords,
                        rotations(q).to(coords.dtype))


def _rows(pick: torch.Tensor, n: int) -> torch.Tensor:
    """[B] positions -> [B, n] bool, True at each row's position."""
    return torch.arange(n, device=pick.device) == pick[:, None]


def _set_rows(onehot: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    return torch.where(sel[..., None], torch.ones_like(onehot), onehot)


def _top_positions(noise: torch.Tensor, count: int) -> torch.Tensor:
    """[B, L] draws -> [B, L] bool with ``count`` distinct positions a row."""
    cols = torch.topk(noise, count, dim=1).indices
    sel = torch.zeros(noise.shape, dtype=torch.bool, device=noise.device)
    return sel.scatter_(1, cols, True)


def ssl_mask_single(node_onehot: torch.Tensor, gumbel: torch.Tensor):
    """Mask one random real residue per graph as all-ones; (masked,
    classes [B] int32). Real residues have a one-hot row sum of exactly 1.
    A graph without one keeps its rows and gets class 0 (the host
    fallback): its all -inf scores pick position 0, which ``any_real``
    then masks out."""
    n = node_onehot.shape[1]
    real = node_onehot.sum(-1) == 1.0                       # [B, N]
    scores = torch.where(real, gumbel, float("-inf"))
    pick = scores.argmax(1)                                 # [B]
    classes = node_onehot.argmax(-1).gather(1, pick[:, None])[:, 0]
    any_real = real.any(1)
    classes = torch.where(any_real, classes, 0).to(torch.int32)
    return _set_rows(node_onehot, _rows(pick, n) & any_real[:, None]), classes


def ssl_mask_paired(onehot_c: torch.Tensor, onehot_w: torch.Tensor,
                    gumbel_c: torch.Tensor, gumbel_w: torch.Tensor):
    """Mask same-class residues in a cancer/WT pair; (masked_c, masked_w,
    classes). A cancer residue is picked uniformly among those whose class
    also has a real residue in the WT graph (class probability follows
    residue frequency, immmunopred_dataloader.py:253-271), then a WT
    residue of that class. Without a common class neither graph is masked
    and the class is 0."""
    b, n, c = onehot_c.shape
    real_c = onehot_c.sum(-1) == 1.0
    real_w = onehot_w.sum(-1) == 1.0
    cls_c = onehot_c.argmax(-1)
    cls_w = onehot_w.argmax(-1)
    # [B, C]: class k has a real residue in the WT graph
    present_w = ((torch.arange(c, device=cls_w.device) == cls_w[..., None])
                 & real_w[..., None]).any(1)
    eligible_c = real_c & present_w.gather(1, cls_c)
    pick_c = torch.where(eligible_c, gumbel_c, float("-inf")).argmax(1)
    has_common = eligible_c.any(1)
    classes = torch.where(has_common, cls_c.gather(1, pick_c[:, None])[:, 0],
                          0).to(torch.int32)
    masked_c = _set_rows(onehot_c, _rows(pick_c, n) & has_common[:, None])
    ok_w = real_w & (cls_w == classes[:, None])
    pick_w = torch.where(ok_w, gumbel_w, float("-inf")).argmax(1)
    masked_w = _set_rows(onehot_w, _rows(pick_w, n)
                         & (has_common & ok_w.any(1))[:, None])
    return masked_c, masked_w, classes


def structure_mask(node_onehot: torch.Tensor, noise: torch.Tensor,
                   count: int) -> torch.Tensor:
    """Zero ``count`` random node rows (the top of ``noise`` [B, N]) unless
    already SSL-masked (row sum > 1)."""
    if count <= 0:
        return node_onehot
    zero_rows = _top_positions(noise, count) & (node_onehot.sum(-1) <= 1.0)
    return torch.where(zero_rows[..., None], torch.zeros_like(node_onehot),
                       node_onehot)


def sequence_mask(seq_onehot: torch.Tensor, noise: Optional[torch.Tensor],
                  count: int) -> torch.Tensor:
    """Set ``count`` random positions (the top of ``noise`` [B,
    maskable_len]) to the 'J' one-hot, the alphabet's last channel."""
    if count <= 0 or noise is None or noise.shape[1] <= 0:
        return seq_onehot
    b, l, a = seq_onehot.shape
    sel = torch.zeros((b, l), dtype=torch.bool, device=seq_onehot.device)
    sel[:, :noise.shape[1]] = _top_positions(noise, count)
    # the 'J' one-hot, built on the device (an indexed write of a Python
    # number would copy it from the host)
    pad = _rows(torch.full((1,), a - 1, device=seq_onehot.device), a)[0]
    return torch.where(sel[..., None], pad.to(seq_onehot.dtype), seq_onehot)


# -- whole batches ---------------------------------------------------------------

def draw_batch(gen: torch.Generator, b: int, n: int, *, ssl: bool = False,
               structure_pad_count: int = 0, sequence_pad_count: int = 0,
               maskable_len: int = 0, rotate: bool = False) -> dict:
    """The draws ``augment_batch_core`` takes, in a fixed order: 'rot'
    [B, 4] normals, 'ssl' [B, N] Gumbels, 'structure' [B, N] and
    'sequence' [B, maskable_len] uniforms; only those the flags use."""
    draws = {}
    if rotate:
        draws["rot"] = normals(gen, (b, 4))
    if ssl:
        draws["ssl"] = gumbels(gen, (b, n))
    if structure_pad_count > 0:
        draws["structure"] = uniforms(gen, (b, n))
    if sequence_pad_count > 0 and maskable_len > 0:
        draws["sequence"] = uniforms(gen, (b, maskable_len))
    return draws


def _rebuild(s: SampleBatch, onehot, coords, seq, aux) -> SampleBatch:
    g = s.graph
    graph = GraphBatch(node_feat=onehot, coords=coords, edge_src=g.edge_src,
                       edge_dst=g.edge_dst, edge_feat=g.edge_feat,
                       edge_mask=g.edge_mask, node_mask=g.node_mask,
                       num_nodes=g.num_nodes)
    return SampleBatch(graph=graph, seq_onehot=seq, props=s.props,
                       target=s.target, aux_residue=aux)


def augment_batch_core(batch: SampleBatch, draws: dict, *, ssl: bool = False,
                       structure_pad_count: int = 0,
                       sequence_pad_count: int = 0,
                       rotate: bool = False) -> SampleBatch:
    """The train-time transforms from ``draw_batch``'s draws. The new
    batch's ``aux_residue`` carries the SSL class (the input's when
    ``ssl`` is off)."""
    g = batch.graph
    coords, onehot, aux = g.coords, g.node_feat, batch.aux_residue
    if rotate:
        coords = rotate_coords(coords, draws["rot"])
    if ssl:
        onehot, aux = ssl_mask_single(onehot, draws["ssl"])
    onehot = structure_mask(onehot, draws.get("structure"),
                            structure_pad_count)
    seq = sequence_mask(batch.seq_onehot, draws.get("sequence"),
                        sequence_pad_count)
    return _rebuild(batch, onehot, coords, seq, aux)


def augment_batch(batch: SampleBatch, gen: torch.Generator, *,
                  ssl: bool = False, structure_pad_count: int = 0,
                  sequence_pad_count: int = 0, maskable_len: int = 0,
                  rotate: bool = False) -> SampleBatch:
    """``augment_batch_core`` on draws from ``gen`` (on the batch's
    device)."""
    b, n, _ = batch.graph.node_feat.shape
    draws = draw_batch(gen, b, n, ssl=ssl,
                       structure_pad_count=structure_pad_count,
                       sequence_pad_count=sequence_pad_count,
                       maskable_len=maskable_len, rotate=rotate)
    return augment_batch_core(batch, draws, ssl=ssl,
                              structure_pad_count=structure_pad_count,
                              sequence_pad_count=sequence_pad_count,
                              rotate=rotate)


def draw_comparative(gen: torch.Generator, b: int, n: int, *,
                     ssl: bool = False, structure_pad_count: int = 0,
                     sequence_pad_count: int = 0, maskable_len: int = 0,
                     rotate: bool = False) -> dict:
    """The draws of ``augment_comparative_core``: 'rot_c', 'rot_w' [B, 4],
    'ssl_c', 'ssl_w' [B, N] Gumbels, 'structure_c', 'structure_w' [B, N]
    and 'sequence' [B, maskable_len] uniforms (one for both twins)."""
    draws = {}
    if rotate:
        draws["rot_c"] = normals(gen, (b, 4))
        draws["rot_w"] = normals(gen, (b, 4))
    if ssl:
        draws["ssl_c"] = gumbels(gen, (b, n))
        draws["ssl_w"] = gumbels(gen, (b, n))
    if structure_pad_count > 0:
        draws["structure_c"] = uniforms(gen, (b, n))
        draws["structure_w"] = uniforms(gen, (b, n))
    if sequence_pad_count > 0 and maskable_len > 0:
        draws["sequence"] = uniforms(gen, (b, maskable_len))
    return draws


def augment_comparative_core(batch: ComparativeBatch, draws: dict, *,
                             ssl: bool = False, structure_pad_count: int = 0,
                             sequence_pad_count: int = 0,
                             rotate: bool = False) -> ComparativeBatch:
    """Paired transforms: independent rotations per twin
    (util_dataloader.py:38-42), same-class SSL masking, the same sequence
    mask positions in both twins (immmunopred_dataloader.py:216-231)."""
    c, w = batch.cancer, batch.wt
    onehot_c, onehot_w = c.graph.node_feat, w.graph.node_feat
    coords_c, coords_w = c.graph.coords, w.graph.coords
    aux = c.aux_residue
    if rotate:
        coords_c = rotate_coords(coords_c, draws["rot_c"])
        coords_w = rotate_coords(coords_w, draws["rot_w"])
    if ssl:
        onehot_c, onehot_w, aux = ssl_mask_paired(
            onehot_c, onehot_w, draws["ssl_c"], draws["ssl_w"])
    onehot_c = structure_mask(onehot_c, draws.get("structure_c"),
                              structure_pad_count)
    onehot_w = structure_mask(onehot_w, draws.get("structure_w"),
                              structure_pad_count)
    seq_c = sequence_mask(c.seq_onehot, draws.get("sequence"),
                          sequence_pad_count)
    seq_w = sequence_mask(w.seq_onehot, draws.get("sequence"),
                          sequence_pad_count)
    return ComparativeBatch(cancer=_rebuild(c, onehot_c, coords_c, seq_c, aux),
                            wt=_rebuild(w, onehot_w, coords_w, seq_w, aux))


def augment_comparative(batch: ComparativeBatch, gen: torch.Generator, *,
                        ssl: bool = False, structure_pad_count: int = 0,
                        sequence_pad_count: int = 0, maskable_len: int = 0,
                        rotate: bool = False) -> ComparativeBatch:
    """``augment_comparative_core`` on draws from ``gen``."""
    b, n, _ = batch.cancer.graph.node_feat.shape
    draws = draw_comparative(gen, b, n, ssl=ssl,
                             structure_pad_count=structure_pad_count,
                             sequence_pad_count=sequence_pad_count,
                             maskable_len=maskable_len, rotate=rotate)
    return augment_comparative_core(batch, draws, ssl=ssl,
                                    structure_pad_count=structure_pad_count,
                                    sequence_pad_count=sequence_pad_count,
                                    rotate=rotate)
