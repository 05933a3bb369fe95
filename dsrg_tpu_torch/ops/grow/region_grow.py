"""Deep seeded region growing as a batched flood fill
(``dsrg_tpu/ops/grow/region_grow.py``; reference ``pylayers.py:237-275``).

The pixels of the seed-containing 8-connected components of a class's
candidate map are the pixels reachable from its seeds through that map, so
the union-find labelling of the reference becomes a flood fill:
``grown = max(min(dilate8(grown), mask), grown)`` to a fixed point.

Reference semantics, bit for bit:

* candidate label map: cue pixels get ``class + 1``, the highest cue class
  winning; the argmax over the image's present classes (the first maximum,
  as ``torch.argmax`` and ``np.argmax`` take) overwrites it with
  ``argc + 1`` when the refined probability exceeds ``th2`` (foreground) or
  both ``th1`` and ``th2`` (background);
* classes run in ascending order and each mutates the seeds the next sees;
* barrier pixels (seeded by exactly one other class) conduct connectivity
  but never become seeds of the growing class.

The whole batch grows at once.  Every ``unroll`` dilations one convergence
check reads a flag back to the host; ``dsrg_grow.checks`` counts them.
While a profiler records, the grow is the span ``dsrg.grow`` and each host
read-back (those checks and the present classes' list) a ``dsrg.grow.sync``
inside it (``utils/profiling.span``).
Classes absent from every image of the batch are skipped: their seeds stay
as they are, as the per-image rule leaves them.  No gradient flows.
:func:`grow_seeds_single` is the grow of one image: the batch of one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dsrg_tpu_torch.utils.profiling import span


def _dilate8(mask: torch.Tensor) -> torch.Tensor:
    """8-connected dilation of (B, h, w) {0,1} masks (3x3 max, -inf pad)."""
    return F.max_pool2d(mask[:, None], 3, 1, 1)[:, 0]


def _flood_fill(seeded: torch.Tensor, mask: torch.Tensor, unroll: int = 4) -> torch.Tensor:
    """Pixels 8-connected-reachable from ``seeded`` within ``mask``, (B, h, w)
    {0,1} floats.  Growth is monotone and idempotent at the fixed point, so
    images that converged early are unchanged by the extra dilations."""
    max_iters = seeded.shape[-2] * seeded.shape[-1]
    dsrg_grow.checks += 1
    with span("dsrg.grow.sync"):
        if not bool(seeded.any()):
            return seeded
    frontier, it = seeded, 0
    while it < max_iters:
        grown = frontier
        for _ in range(unroll):
            grown = torch.maximum(torch.minimum(_dilate8(grown), mask), grown)
        it += unroll
        dsrg_grow.checks += 1
        with span("dsrg.grow.sync"):
            if not bool((grown != frontier).any()):
                return grown
        frontier = grown
    return frontier


def _threshold(th: float, like: torch.Tensor) -> torch.Tensor:
    """``th`` as a 0-d tensor of ``like``'s dtype, so the comparison rounds
    it as the JAX package does (to float32)."""
    return torch.tensor(th, dtype=like.dtype, device=like.device)


@torch.no_grad()
@span("dsrg.grow")
def dsrg_grow(image_labels: torch.Tensor, cues: torch.Tensor, probs_refined: torch.Tensor,
              th1: float = 0.99, th2: float = 0.85) -> torch.Tensor:
    """(B, M) labels, (B, h, w, M) cues and refined probabilities ->
    (B, h, w, M) grown seed cues."""
    m = cues.shape[-1]
    present = image_labels > 0.5  # (B, M)
    masked = torch.where(present[:, None, None, :], probs_refined,
                         torch.tensor(float("-inf"), dtype=probs_refined.dtype,
                                      device=probs_refined.device))
    argc = torch.argmax(masked, dim=-1)  # first max, ascending class order
    maxp = masked.amax(dim=-1)
    class_ids = torch.arange(1, m + 1, device=cues.device)
    cue_label = torch.where(cues > 0.5, class_ids, 0).amax(dim=-1)  # highest cue class wins

    fg_hit = (maxp > _threshold(th2, maxp)) & (argc != 0)
    bg_hit = (argc == 0) & (maxp > _threshold(th1, maxp)) & (maxp > _threshold(th2, maxp))
    label_map = torch.where(fg_hit, argc + 1, cue_label)
    label_map = torch.where(bg_hit, 1, label_map)

    seed = (cues > 0.5).float().permute(0, 3, 1, 2).contiguous()  # (B, M, h, w)
    with span("dsrg.grow.sync"):
        classes = torch.nonzero(present.any(0)).flatten().tolist()
    for c in classes:
        mat = (label_map == c + 1).float()
        is_seed_c = seed[:, c]
        barrier = mat * (1.0 - is_seed_c) * (seed.sum(1) == 1.0).float()
        reach = _flood_fill(mat * is_seed_c, mat)
        new_c = torch.maximum(is_seed_c, reach * (1.0 - barrier))
        seed[:, c] = torch.where(present[:, c, None, None], new_c, is_seed_c)
    return seed.permute(0, 2, 3, 1).contiguous()


def grow_seeds_single(image_labels: torch.Tensor, cues: torch.Tensor, probs_refined: torch.Tensor,
                      th1: float = 0.99, th2: float = 0.85) -> torch.Tensor:
    """One image's grow: (M,) labels (bit 0, background, always set),
    (h, w, M) cues and refined probabilities -> (h, w, M) grown seeds, the
    same as :func:`dsrg_grow` on a batch of that one image."""
    return dsrg_grow(image_labels[None], cues[None], probs_refined[None], th1, th2)[0]


dsrg_grow.checks = 0
