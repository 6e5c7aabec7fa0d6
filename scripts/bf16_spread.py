"""Where bf16 parts from f32 on chip_smoke phase 9's weights, layer by layer,
on one card: for each config (phase 9's rows, prompt and seed; weights
drawn in f32 on the card and cast to bf16, as ``bf16_phase`` draws them),
one ``prefill`` in four ways: f32 and bf16, each through the kernels and
through their plain versions (``kernels/ref.py`` on the card, swapped in
for the wrappers the models call). Every residual-stream input of an RMS
norm (two or three a layer, the final norm last) is kept at each row's
last token, and each way is held against the f32 kernel run: the largest
relative L2 over the rows at each norm, and at the logits the row
relative L2 and the largest |difference| over the largest |f32 logit|.
The f32 plain run shows how far the network carries f32's own rounding;
bf16 through the plain versions, how far bf16 alone parts from f32, with
no kernel in it. Prints the card's name and power limit, then one JSON
line (also written to the path after ``--out``, where given).

    python3 scripts/bf16_spread.py [--arch NAME ...] [--out PATH]
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

DEFAULT_ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b", chip_smoke.ENCDEC_ARCH)


class NormInputs:
    """While in use, keeps every RMS norm's input at each row's last token
    (f64, on the host), in call order."""

    MODULES = ("repro_torch.models.transformer", "repro_torch.models.encdec")

    def __enter__(self):
        self.rows, self.saved = [], {}
        for name in self.MODULES:
            mod = importlib.import_module(name)
            self.saved[mod] = mod.rms_norm

            def norm(x, w, eps, _fn=mod.rms_norm):
                self.rows.append(x[:, -1].detach().double().cpu())
                return _fn(x, w, eps)

            mod.rms_norm = norm
        return self

    def __exit__(self, *exc):
        for mod, fn in self.saved.items():
            mod.rms_norm = fn


def spread(name: str, dev) -> dict:
    from repro_torch import configs
    from repro_torch.models import build_model

    (B, S, chunk_len, steps), = [(b, s, c, n) for a, b, s, c, n, _ in chip_smoke.BF16_ARCHS
                                 if a == name]
    cfg = configs.get(name)
    max_len = chip_smoke.phase9_max_len(S, chunk_len, steps)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(2))
    ids = torch.tensor([0, 1, 2, 3, 4, 5, 6, -1][:B - 1] + [-1], dtype=torch.int32)
    src = ()
    if cfg.is_encdec:
        src = (torch.randn((B, S, cfg.d_model),
                           generator=torch.Generator().manual_seed(3)).to(dev),)
    m32 = build_model(cfg, dtype=torch.float32, device=dev)
    p32 = m32.init_params(torch.Generator(device=dev).manual_seed(0))
    l32 = chip_smoke.random_lora(m32, 8, 1)
    m16 = build_model(cfg, device=dev)
    p16, l16 = chip_smoke.cast_tree(p32, torch.bfloat16), chip_smoke.cast_tree(l32, torch.bfloat16)

    def run(model, params, lora, plain: bool):
        with torch.no_grad(), NormInputs() as rec:
            if plain:
                with chip_smoke.PlainKernels():
                    logits, _ = model.prefill(params, *src, tokens, max_len, lora=lora,
                                              adapter_ids=ids)
            else:
                logits, _ = model.prefill(params, *src, tokens, max_len, lora=lora,
                                          adapter_ids=ids)
        return rec.rows, logits[:, -1].double().cpu()

    base_rows, base_logits = run(m32, p32, l32, False)
    top = float(base_logits.abs().max())
    out = {"arch": name, "batch": B, "prompt_tokens": S, "norms": len(base_rows)}
    for key, args in (("f32_plain", (m32, p32, l32, True)),
                      ("bf16_kernels", (m16, p16, l16, False)),
                      ("bf16_plain", (m16, p16, l16, True))):
        rows, logits = run(*args)
        chip_smoke.require(len(rows) == len(base_rows), f"{name} {key}: norm count")
        out[key] = {
            "norm_input_max_rel_l2": [float(chip_smoke.rel_l2(r, b).max())
                                      for r, b in zip(rows, base_rows)],
            "logit_max_rel_l2": float(chip_smoke.rel_l2(logits, base_logits).max()),
            "logit_max_abs_share": float((logits - base_logits).abs().max()) / top}
    del m32, p32, l32, m16, p16, l16
    torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bf16_spread: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    # as chip_smoke's main() sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    args = sys.argv[1:]
    archs = [args[i + 1] for i, a in enumerate(args) if a == "--arch"] or DEFAULT_ARCHS
    dev = torch.device("cuda")
    out = {"nvidia_smi": smi, "archs": [spread(name, dev) for name in archs]}
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    if "--out" in args:
        path = Path(args[args.index("--out") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out))


if __name__ == "__main__":
    main()
