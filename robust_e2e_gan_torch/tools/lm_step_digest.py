"""Digests of the RNNLM step's outputs on its "tile" route.

    python -m robust_e2e_gan_torch.tools.lm_step_digest

Needs the card and nvcc. Runs ``ops/lm_step.py::lm_step`` on the "tile"
route (``csrc/lm_step_tile.cu``) at the shapes ``chip_smoke.py``'s phase 3
runs it (N = 1,024 lanes, V=52: E=128 and H=256 in float32 and bfloat16,
with one layer and two; the decode CLI's E=H=512, V=12) on inputs drawn
from a fixed seed on the card, and prints the SHA-256 of each case's h, c
and logits bytes. Run in two checkouts (``cd <checkout> && python -m
robust_e2e_gan_torch.tools.lm_step_digest``), equal lines show that a
change to the kernel's sources left its outputs bit for bit as they were.
"""

from __future__ import annotations

import hashlib

import torch

from robust_e2e_gan_torch.ops import lm_step

# (tag, N, V, E, H, layers, compute dtype)
CASES = [("lmconfig-f32", 1024, 52, 128, 256, 1, torch.float32),
         ("lmconfig-bf16", 1024, 52, 128, 256, 1, torch.bfloat16),
         ("2layers-f32", 1024, 52, 128, 256, 2, torch.float32),
         ("cli-e512-h512", 1024, 12, 512, 512, 1, torch.float32)]


def digest(n, v, e, h, layers, dtype, seed: int = 0) -> str:
    """SHA-256 of one tile-route step's (h, c, logits) on seeded inputs."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    tok = torch.randint(0, v, (n,), generator=gen, device=dev)
    emb = rnd(v, e, scale=e ** -0.5)
    wxs = [rnd(e if i == 0 else h, 4 * h, scale=(e if i == 0 else h) ** -0.5)
           for i in range(layers)]
    whs = [rnd(h, 4 * h, scale=h ** -0.5) for _ in range(layers)]
    biases = [rnd(4 * h, scale=0.1) for _ in range(layers)]
    out_w, out_b = rnd(h, v, scale=h ** -0.5), rnd(v, scale=0.1)
    h0, c0 = rnd(layers, n, h, scale=0.5), rnd(layers, n, h, scale=0.5)
    before = lm_step.LM_ROUTE_LAUNCHES["tile"]
    with torch.no_grad(), lm_step._force_lm_route("tile"):
        outs = lm_step.lm_step(tok, emb, wxs, whs, biases, out_w, out_b, h0,
                               c0, dtype=dtype)
    torch.cuda.synchronize()
    assert lm_step.LM_ROUTE_LAUNCHES["tile"] == before + 1
    sha = hashlib.sha256()
    for x in outs:
        sha.update(x.contiguous().cpu().numpy().tobytes())
    return sha.hexdigest()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lm_step_digest needs a CUDA device")
    for tag, *shape in CASES:
        print(f"{tag}: {digest(*shape)}")


if __name__ == "__main__":
    main()
