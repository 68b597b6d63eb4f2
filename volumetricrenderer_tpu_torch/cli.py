"""Command-line entry point of the PyTorch port (port of the `fit`
subcommand of volumetricrenderer_tpu/cli.py).

Usage:
  python -m volumetricrenderer_tpu_torch fit --size 32 --steps 100 \
      --out-dir fit_run/

The fit runs on the GPU when torch sees one (the sweep kernels forward and
backward), else on the CPU (their plain versions).

The JAX package's other subcommands (render, animate, serve, info) are not
ported yet.
"""
from __future__ import annotations

import argparse
import os
import sys


def cmd_fit(args):
    import torch

    from .config import CameraConfig, LightConfig, MediumConfig, RenderConfig
    from .fit import fit_grid
    from .models.scene import cloud_volume
    from .ops.camera import camera_rays, make_camera
    from .ops.integrate import render_rays
    from .render import render_image
    from .utils.checkpoint import (adam_initial_leaves, latest_step,
                                   restore_checkpoint, save_checkpoint)
    from .utils.image import write_png
    from .utils.metrics import MetricsWriter, get_logger

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    os.makedirs(args.out_dir, exist_ok=True)
    # Default: the slice sweep, differentiated through the sweep kernels
    # on a GPU; --quadrature fixed is the per-ray march of ops/integrate.
    if args.quadrature == "sliced":
        cfg = RenderConfig(emission=True, quadrature="sliced")
    else:
        cfg = RenderConfig(max_steps=64, step_size=4.0 / 64.0,
                           emission=True)
    med = MediumConfig(combine="single", density=8.0)
    light = LightConfig()
    cam = make_camera(CameraConfig(width=args.image_size,
                                   height=args.image_size))

    true_grid = cloud_volume(args.size, seed=7, device=dev)
    if args.quadrature == "sliced":
        def render(g):
            return render_image(g, cam, cfg, med, light)
    else:
        o, d = (t.to(dev) for t in camera_rays(cam))

        def render(g):
            return render_rays(g, o, d, cfg, med, light)
    with torch.no_grad():
        target = render(true_grid)[..., :3]
    write_png(os.path.join(args.out_dir, "target.png"), target)

    metrics = MetricsWriter(os.path.join(args.out_dir, "metrics.jsonl"))
    ckpt_dir = os.path.join(args.out_dir, "ckpt")
    init_grid = init_opt = None
    start = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        start, init_grid, init_opt, extra = restore_checkpoint(
            ckpt_dir, opt_state_template=adam_initial_leaves(
                (args.size,) * 3))
        # A checkpoint written under another quadrature would continue
        # under another loss: refuse. Checkpoints without the metadata
        # resume with a warning, as in the JAX package.
        ck_quad = extra.get("quadrature")
        if ck_quad is None:
            get_logger().warning(
                "checkpoint has no quadrature metadata; resuming under "
                "--quadrature %s", args.quadrature)
        elif ck_quad != args.quadrature:
            raise SystemExit(
                f"checkpoint at {ckpt_dir} was written with quadrature "
                f"{ck_quad!r} but --quadrature is {args.quadrature!r}; "
                "resuming would optimize a different loss. Re-run with "
                f"--quadrature {ck_quad} or a fresh --out-dir.")
        get_logger().info("resuming fit from step %d (%s)", start, ckpt_dir)
        init_grid = torch.as_tensor(init_grid, device=dev)
    res = fit_grid(
        target, cam, cfg, med, light, grid_size=args.size,
        steps=args.steps, learning_rate=args.lr, metrics=metrics,
        init_grid=init_grid, init_opt_state=init_opt, start_step=start,
        checkpoint_fn=lambda s, g, st: save_checkpoint(
            ckpt_dir, s, g, st, extra={"quadrature": args.quadrature}),
        checkpoint_every=max(args.steps // 4, 1))
    with torch.no_grad():
        final = render(res.grid)
    write_png(os.path.join(args.out_dir, "fitted.png"), final[..., :3])
    metrics.close()
    if res.losses:
        get_logger().info("fit: loss %.6f -> %.6f; artifacts in %s",
                          res.losses[0], res.losses[-1], args.out_dir)
    else:
        get_logger().info("fit: already complete at step %d; artifacts "
                          "in %s", res.steps, args.out_dir)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="volumetricrenderer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pf = sub.add_parser("fit", help="inverse-render fit demo (config 3)")
    pf.add_argument("--size", type=int, default=32)
    pf.add_argument("--image-size", type=int, default=64)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=5e-2)
    pf.add_argument("--out-dir", default="fit_run")
    pf.add_argument("--quadrature", default="sliced",
                    choices=["sliced", "fixed"],
                    help="sliced = differentiate through the slice sweep "
                         "(the sweep kernels on a GPU; default); fixed = "
                         "the per-ray march")
    pf.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "<out-dir>/ckpt")
    pf.set_defaults(fn=cmd_fit)

    args = parser.parse_args(argv)
    from .utils.metrics import init_logs
    init_logs()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
