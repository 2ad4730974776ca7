"""Serves saved `infer/aot.py` artifacts in a process that has no model
code: the serving side of an artifact, and its check.

    python -m laudnet_tpu_torch.tools.serve_artifact IMAGES OUT_DIR \\
        ARTIFACT.pt2 [ARTIFACT.pt2 ...]

Loads each artifact with `infer.aot.load_serving_artifact` (which imports
only `laudnet_tpu_torch.ops`, for the kernels' registered ops), runs it on
the images saved with ``torch.save`` in IMAGES, and writes
``OUT_DIR/<name>.pt`` (the logits) and ``OUT_DIR/<name>.json``: the CUDA
kernels one call launched, by name (`torch.profiler`), whether a batch
one image short was refused, and the ``laudnet_tpu_torch`` modules the
process had imported. Prints one JSON line of the same per artifact.
"""

from __future__ import annotations

import json
import os
import sys

import torch


def kernel_counts(fn, tries: int = 6) -> dict:
    """The CUDA kernels one call of ``fn`` launches, by name (copies and
    fills aside), from `torch.profiler`. The profiler can drop events (a
    whole buffer of a trace), so the trace is taken again until two in a
    row agree; a call's kernels are deterministic."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append({e.key: e.count for e in prof.key_averages()
                       if e.device_type.name == "CUDA"
                       and not e.key.startswith(("Memcpy", "Memset"))})
        if len(counts) > 1 and counts[-1] == counts[-2]:
            break
    return counts[-1]


def serve(images_path: str, out_dir: str, artifacts) -> list:
    from laudnet_tpu_torch.infer.aot import load_serving_artifact

    os.makedirs(out_dir, exist_ok=True)
    images = torch.load(images_path, weights_only=True)
    results = []
    for path in artifacts:
        name = os.path.basename(path).removesuffix(".pt2")
        fn = load_serving_artifact(path)
        logits = fn(images)  # the first call: lazy initialisation
        counts = kernel_counts(lambda: fn(images))
        try:
            fn(images[:-1])
            refused = False
        except Exception:  # the program's shape guard, whatever its type
            refused = True
        torch.save(logits.cpu(), os.path.join(out_dir, name + ".pt"))
        row = {"name": name, "kernels": counts,
               "refused_other_batch": refused,
               "port_modules": sorted(m for m in sys.modules
                                      if m.startswith("laudnet_tpu_torch"))}
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(row, f)
        print(json.dumps(row))
        results.append(row)
    return results


if __name__ == "__main__":
    serve(sys.argv[1], sys.argv[2], sys.argv[3:])
