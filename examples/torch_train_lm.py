"""End-to-end LM training on the PyTorch port: data pipeline -> model ->
AdamW -> fault-tolerant loop with checkpointing, on one device.

Default preset trains a ~25M-param model long enough to see the loss fall;
`--preset 100m --steps 300` is the paper-brief configuration.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 120] [--preset small]

The CLI of `examples/train_lm.py` plus `--device` (default the card; `cpu`
runs the plain-torch path).  Weights are drawn from seed 0 on the device,
so the losses are the port's own, not the reference's.  Checkpoints are
written in the reference's layout.
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import AttnCfg, ModelConfig
from repro_torch.models import build_model
from repro_torch.models.model import count_params
from repro_torch.train.data import DataConfig, SyntheticDataset
from repro_torch.train.elastic import SimulatedFailures
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import adamw, cosine_schedule
from repro_torch.train.train_step import make_train_step

PRESETS = {
    "small": dict(n_layers=4, d_model=384, d_ff=1536, vocab=4096,
                  heads=6, kv=2, seq=128, batch=8),
    "100m": dict(n_layers=12, d_model=768, d_ff=3072, vocab=16384,
                 heads=12, kv=4, seq=512, batch=8),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--inject-failure", action="store_true",
                    help="kill the loop mid-run to demo checkpoint restart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    p = PRESETS[args.preset]

    cfg = ModelConfig(
        name=f"lm-{args.preset}", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], d_ff=p["d_ff"],
        vocab=p["vocab"],
        attn=AttnCfg(n_heads=p["heads"], n_kv=p["kv"],
                     head_dim=p["d_model"] // p["heads"]),
        vocab_pad_to=128, remat="none",
    )
    model = build_model(cfg, args.device)
    params, _ = model.init(0)
    print(f"model: {count_params(cfg)/1e6:.1f}M params")

    opt = adamw(cosine_schedule(3e-3, warmup=20, total=args.steps),
                weight_decay=0.01, grad_clip=1.0)
    step = make_train_step(model, opt, microbatches=2)
    data = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq=p["seq"],
                                       global_batch=p["batch"]),
                            device=model.device)
    failures = SimulatedFailures(fail_at=(args.steps // 2,)) \
        if args.inject_failure else None
    res = train_loop(step, params, opt.init(params), data,
                     LoopConfig(total_steps=args.steps, checkpoint_every=40,
                                checkpoint_dir=args.ckpt_dir, log_every=10),
                     failures=failures, model_cfg=cfg)
    print(f"done: loss {res['losses'][0]:.3f} -> {res['losses'][-1]:.3f} "
          f"({res['restarts']} restarts, {res['stragglers']} stragglers)")
    return res


if __name__ == "__main__":
    main()
