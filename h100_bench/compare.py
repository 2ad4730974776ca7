"""The comparison that decides ``correct``: the outputs the timed path
produced, against the reference's on the same inputs.

Served logits are compared image by image. ``image_rel`` of an image is
the norm of its logits' difference from the reference's over the norm of
the reference's. The numbers a configuration can compare (its file's
``limits`` says which, each with its limit):

- ``logit_rel``: the same ratio over every logit checked;
- ``image_rel_max``: the largest ``image_rel``;
- ``mask_disagree``: where the reference follows the decisions each
  served call took (the program's state, read as the call ran: the gates
  are hard compares, and the card's rounding moves a near-tied one, which
  the reference would then judge as a wrong answer), the share of those
  decisions that the reference's own gates take otherwise;
- ``gate_flip_margin``: where the reference judges the gates by their
  margins, the widest margin by which its own gate decides otherwise than
  the served call did, over the root mean square margin at that gate:
  rounding flips only gates near their tie, and a gate that decides
  wrongly, or a selection that leaves a kept token out, reads far from it.

An output of the wrong shape, or one that is not finite, reads infinite.
"""

from __future__ import annotations

import math
import statistics

import torch


def served_errors(outputs, refs):
    """``outputs``: (pool index, logits) of every batch checked; ``refs``:
    the reference's float32 logits of each pool batch. Returns
    ``(logit_rel, per-image rel errors (N,), images checked)``."""
    diff2 = ref2 = 0.0
    per_image = []
    images = 0
    for p, out in outputs:
        ref = refs[p]
        images += ref.shape[0]
        if tuple(out.shape) != tuple(ref.shape):
            per_image.append(torch.full((ref.shape[0],), math.inf))
            diff2 = math.inf
            continue
        d = out.float().to(ref.device) - ref
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))
        e2 = (d * d).sum(-1)
        r2 = (ref * ref).sum(-1)
        diff2 += float(e2.sum())
        ref2 += float(r2.sum())
        per_image.append((e2.sqrt() / r2.sqrt().clamp_min(1e-30)).cpu())
    rel = math.sqrt(diff2 / ref2) if ref2 > 0 else math.inf
    per_image = torch.cat(per_image) if per_image else torch.zeros(0)
    return rel, per_image, images


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def judge_served(run, weights, pool, outputs, precision="f32"):
    """Compares every served batch, ``(pool index, logits, state)``, with
    the reference on its pool batch, following the decisions ``state`` the
    call took where it is given: one reference run for each distinct pair
    of pool batch and decisions. Returns the numbers, the per-image
    errors, the images checked and the reference's facts of each pool
    batch (at the first decisions judged on it; at the reference's own
    where no call on it was checked)."""
    groups = []   # (pool index, state, count)
    index = []
    for p, _, state in outputs:
        for g, (q, st, _) in enumerate(groups):
            if q == p and _same(st, state):
                groups[g] = (q, st, groups[g][2] + 1)
                index.append(g)
                break
        else:
            groups.append((p, state, 1))
            index.append(len(groups) - 1)
    refs, infos = [], []
    for p, state, _ in groups:
        logits, info = run.reference.forward(weights, pool[p], run.config,
                                             precision=precision,
                                             state=state)
        refs.append(logits)
        infos.append(info)
    out, per_image, images = numbers(
        [(g, o) for g, (_, o, _) in zip(index, outputs)], refs, infos,
        [c for _, _, c in groups])
    run.facts["decision_sets"] = len(groups)
    first = {}
    for (p, _, _), info in zip(groups, infos):
        first.setdefault(p, info)
    for p in range(len(pool)):  # a pool batch no sampled call served
        if p not in first:
            first[p] = run.reference.forward(weights, pool[p], run.config,
                                             precision=precision)[1]
    return out, per_image, images, [first[p] for p in range(len(pool))]


def numbers(outputs, refs, infos, counts=None):
    """The numbers compared for ``outputs`` (reference index, logits)
    against ``refs``, with the per-image errors and the images checked;
    ``counts``: the batches each reference judged, which weigh its
    decisions' disagreement."""
    rel, per_image, images = served_errors(outputs, refs)
    out = {"logit_rel": rel,
           "image_rel_max": (float(per_image.max()) if per_image.numel()
                             else math.inf)}
    if "disagree" in infos[0]:
        counts = counts or [1] * len(infos)
        out["mask_disagree"] = (
            sum(c * float(i["disagree"].sum()) for c, i in zip(counts, infos))
            / max(1.0, sum(c * float(i["cells"].sum())
                           for c, i in zip(counts, infos))))
    if "flip_margin" in infos[0]:
        out["gate_flip_margin"] = max(float(i["flip_margin"].max())
                                      for i in infos)
    return out, per_image, images


def check_served(run, numbers, per_image) -> None:
    """Records the numbers the configuration compares, with their limits,
    and the checked images that failed: an image fails where it has no
    finite answer of the right shape, or, where ``image_rel_max`` is
    compared, where its own error is over that limit."""
    limits = run.config["limits"][run.traffic["mode"]]
    for name, limit in limits.items():
        run.check(name, numbers.get(name, math.inf), limit)
    bad = ~torch.isfinite(per_image)
    if "image_rel_max" in limits:
        bad |= per_image > limits["image_rel_max"]
    run.failed = int(bad.sum())


def leaf_gaps(program, ref, names) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    rn = {k: float(ref[k].float().norm()) for k in names}
    med = statistics.median(rn.values())
    return [abs(float(program[k].float().norm()) - rn[k]) / max(rn[k], med)
            for k in names]


def train_numbers(served, ref) -> dict:
    """The training cell's numbers: ``loss_gap``, the largest relative gap
    of a checked step's loss; ``grad_gap``, the worst leaf of the first
    gradient as SGD takes it; ``change_gap``, the worst leaf of the
    parameters' change over the checked steps, of the leaves whose
    reference gradient is at least a thousandth of the median leaf's
    (under that, a leaf moves by round-off alone); ``grad_gap_median``
    and ``change_gap_median``, the median leaf's; ``mask_disagree``, the
    share of the first step's gate decisions that the reference's own
    gates take otherwise, and ``gate_flip_margin``, the widest margin
    among those, over the root mean square margin of its block."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(served["losses"], ref["losses"])]
    grads = ref["first_grad"]
    norms = {k: float(g.norm()) for k, g in grads.items()}
    med = statistics.median(norms.values())
    moved = [k for k, n in norms.items() if n >= 1e-3 * med]
    before = served["before"]
    change_p = {k: served["after"][k] - before[k] for k in moved}
    change_r = {k: ref["after"][k] - before[k] for k in moved}
    grad = leaf_gaps(served["first_grad"], grads, list(grads))
    change = leaf_gaps(change_p, change_r, moved)
    out = {"loss_gap": max(losses) if losses else math.inf,
           "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
           "change_gap": max(change),
           "change_gap_median": statistics.median(change),
           "mask_disagree": ref["mask_disagree"],
           "gate_flip_margin": ref["gate_flip_margin"]}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def rows_fit(served, batches) -> bool:
    """Whether every noise draw and decision of the checked steps has a
    row for each image the step was fed (a step that drew for other rows
    computed on other rows, and reads infinite)."""
    return all(t.shape[0] == len(y)
               for (_, y), noise, masks in zip(batches, served["noise"],
                                               served["masks"])
               for t in list(noise) + list(masks))


INFINITE = {k: math.inf for k in (
    "loss_gap", "grad_gap", "grad_gap_median", "change_gap",
    "change_gap_median", "mask_disagree", "gate_flip_margin")}


def check_trained(run, numbers, steps) -> None:
    """Records the training cell's numbers with their limits; the checked
    steps are the attempted, and all fail where a number is over."""
    for name, limit in run.config["limits"]["train"].items():
        run.check(name, numbers.get(name, math.inf), limit)
    run.attempted = steps
    run.failed = 0 if run.correct else steps
