"""MSC on a model's activations — counterpart of
`examples/msc_activations.py`.

The paper's method is a generic third-order tensor analysis; here it
runs over (layers × tokens × features) activations of a reduced LM to
find groups of layers, token positions and feature dims with aligned
spectra: redundant-layer discovery.  Two of the four "layers" are made
nearly identical, a cluster MSC must find.

  PYTHONPATH=src python -m repro_torch.examples.msc_activations
  PYTHONPATH=src python -m repro_torch.examples.msc_activations --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import MSCConfig, cluster_activations, resolve_device
from repro_torch.models import build_model, forward


def layer_activations(dev) -> list:
    """Four (S, D) activations of a 2-layer qwen1.5-0.5b (random weights
    from seed 0, 48 tokens from seed 1): the embedding, the final hidden
    state, a near-copy of it (1% noise, seed 2) and half the embedding."""
    cfg = get_config("qwen1.5-0.5b").reduced(n_layers=2, scan_layers=False)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), dtype=torch.int32,
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        h, _ = forward(params, tokens, cfg)
        emb = params["embed"][tokens.long()].to(h.dtype)[0]
    noise = 0.01 * torch.randn(h[0].shape, device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(2)).to(h.dtype)
    return [emb, h[0], h[0] + noise, emb * 0.5]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    dev = resolve_device(ap.parse_args(argv).device)
    result = cluster_activations(
        layer_activations(dev), cfg=MSCConfig(epsilon=1e-3, power_iters=50,
                                              max_extraction_iters=8),
        device=dev)
    layer_mask = result.modes[0].mask
    print("layer-mode cluster mask:", layer_mask.tolist())
    print("marginal similarity d:",
          [round(float(x), 3) for x in result.modes[0].d])
    if not (bool(layer_mask[1]) and bool(layer_mask[2])):
        raise RuntimeError("the near-duplicate layers were not co-clustered")
    print("redundant layers detected: indices",
          [i for i, v in enumerate(layer_mask.tolist()) if v])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
