"""LAUD-DeiT-S with token selection: the weights made from the seed and
the port's serving entry built on them.

Weights (the token-gated recipe): every product's weight normal at
1/sqrt(fan_in), cut at two standard deviations; biases, LayerNorm shifts
and the embeddings small and random, LayerNorm scales about 1. The token
gates of ``gated_layers`` compare a random unit-scale direction of the
token with its opposite, unbiased, so that about half of the tokens close
there; every other gate has a zero kernel and is held open by a bias of
``open_bias`` (a random kernel would close the odd token at a near tie
inside the block kernels, where no decision can be read). All are drawn on
the card from one generator in one call, in float32, and served in
``dtype``. Then the reference's forward over ``centre_images`` seeded
images (made as the cell's traffic makes them) sets each gated layer's
keep bias, layer after layer, so that the median margin of the tokens
reaching it kept sits at the tie: about half of them close there, whatever
the seed (without it the share kept swings with the seed's direction from
a tenth to every token the capacity holds).
"""

from __future__ import annotations

import contextlib
import math

import torch

from h100_bench import images


def shapes(cfg) -> dict:
    """name -> shape of every weight, under the port's parameter names."""
    d, hid, p = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    n = (cfg["image_size"] // p) ** 2 + 1
    out = {"patch_embed.weight": (d, 3, p, p), "patch_embed.bias": (d,),
           "cls_token": (1, 1, d), "pos_embed": (1, n, d)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"blocks.{i}."
        out.update({pre + "token_policy.weight": (2, d),
                    pre + "token_policy.bias": (2,),
                    pre + "norm1.weight": (d,), pre + "norm1.bias": (d,),
                    pre + "qkv.weight": (3 * d, d), pre + "qkv.bias": (3 * d,),
                    pre + "proj.weight": (d, d), pre + "proj.bias": (d,),
                    pre + "norm2.weight": (d,), pre + "norm2.bias": (d,),
                    pre + "fc1.weight": (hid, d), pre + "fc1.bias": (hid,),
                    pre + "fc2.weight": (d, hid), pre + "fc2.bias": (d,)})
    out.update({"norm.weight": (d,), "norm.bias": (d,),
                "head.weight": (cfg["num_labels"], d),
                "head.bias": (cfg["num_labels"],)})
    return out


def make_weights(run) -> dict:
    cfg = run.config
    rec = cfg["weights"]
    table = shapes(cfg)
    total = sum(math.prod(s) for s in table.values())
    g = torch.Generator(run.device).manual_seed(run.sub_seed(0))
    flat = torch.randn(total, generator=g, device=run.device).clamp_(-2, 2)
    gated = set(cfg["gated_layers"])
    out, at = {}, 0
    with torch.no_grad():
        for name, shape in table.items():
            n = math.prod(shape)
            w = flat[at:at + n].view(shape)
            at += n
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("token_policy.weight"):
                layer = int(name.split(".")[1])
                if layer in gated:   # +v against -v: half the tokens close
                    w[1] = -w[0]
                else:                # open whatever the token holds
                    w.zero_()
            elif name.endswith("token_policy.bias"):
                layer = int(name.split(".")[1])
                open_bias = 0.0 if layer in gated else rec["open_bias"]
                w.copy_(torch.tensor([open_bias, -open_bias]))
            elif "norm" in name and leaf == "weight":
                w.mul_(rec["norm_scale"]).add_(1.0)
            elif "norm" in name:
                w.mul_(rec["norm_scale"])
            elif leaf == "weight":
                w.mul_(1 / math.sqrt(math.prod(shape[1:])))
            else:  # biases, the class token, position embeddings
                w.mul_(rec["small_scale"])
            out[name] = w.to(getattr(torch, cfg["dtype"]))
    g = torch.Generator(run.device).manual_seed(run.sub_seed(2))
    x = images.make(run.traffic.get("image", {}), cfg["image_size"],
                    rec["centre_images"], g, run.device)
    run.reference.centre(out, x, cfg)
    return out


@contextlib.contextmanager
def decisions(serve):
    """While open, each gather of the serving entry's block engine (its
    ``gate_and_select``) appends to the list it yields the tokens it kept
    (B, k) and their masks (B, k): the decisions the reference follows.
    Nothing is computed or copied on the card. The model's own graph (no
    block engine, off the card) appends nothing."""
    from laudnet_tpu_torch.infer import fused_vit

    inner = fused_vit.gate_and_select
    sink = []

    def read(x, token_mask, policy, k):
        out = inner(x, token_mask, policy, k)
        if out[2] is not None:
            sink.append((out[2], out[1]))
        return out

    fused_vit.gate_and_select = read
    try:
        yield sink
    finally:
        fused_vit.gate_and_select = inner


def build_serve(run, weights):
    """The port's `ServingEngine` over LAUD-DeiT-S with these weights: on
    a card, the block engine at the snapped capacities."""
    from laudnet_tpu_torch.infer.engine import ServingEngine
    from laudnet_tpu_torch.models.laud_vit import LAUDViT

    cfg, traffic = run.config, run.traffic
    model = LAUDViT(
        depth=cfg["num_hidden_layers"], dim=cfg["hidden_size"],
        num_heads=cfg["num_heads"],
        mlp_ratio=cfg["intermediate_size"] / cfg["hidden_size"],
        patch_size=cfg["patch_size"], num_classes=cfg["num_labels"],
        img_size=cfg["image_size"], token_skip=True, head_skip=False,
        layer_skip=False, token_capacity=tuple(cfg["token_capacity"]),
        device=run.device, dtype=getattr(torch, cfg["dtype"]))
    model.load_state_dict(weights)
    model.eval()
    return ServingEngine(model, batch_size=traffic["batch"],
                         snap_capacities=cfg["snap_capacities"],
                         fast_math=cfg["fast_math"])
