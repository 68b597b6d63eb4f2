"""Command-line entry point of the PyTorch port (port of
volumetricrenderer_tpu/cli.py).

Usage:
  python -m volumetricrenderer_tpu_torch render --preset config2 \
      --out frame.png
  python -m volumetricrenderer_tpu_torch animate --preset config4 \
      --frames 48 --orbit --out-dir frames/
  python -m volumetricrenderer_tpu_torch serve --preset config2
  python -m volumetricrenderer_tpu_torch serve --preset reference \
      --quadrature sliced
  python -m volumetricrenderer_tpu_torch fit --size 32 --steps 100 \
      --out-dir fit_run/
  python -m volumetricrenderer_tpu_torch fit --preset config5 --steps 100 \
      --out-dir fit_run5/
  python -m volumetricrenderer_tpu_torch fit --preset reference \
      --steps 100 --out-dir fit_ref/
  python -m volumetricrenderer_tpu_torch info

Every subcommand takes --device, "cuda" by default: the sweep kernels
forward and backward. Without a GPU the command fails with torch's own
error; only --device cpu runs the kernels' plain versions on the CPU.

render, animate and serve take a preset's sizes (--width, --height,
--volume-size) and its quadrature (--quadrature): the `reference` preset
marches per ray ("fixed"); with --quadrature sliced its (128, 128, 128, 4)
grid goes through the slice sweep's 4-channel kernels. fit differentiates
through the slice sweep unless given --quadrature fixed, for every preset:
`fit --preset reference` fits the four channels through the 4-channel
kernels forward and backward.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help='torch device to run on (default "cuda": fails '
                        'without a GPU); "cpu" runs the plain PyTorch '
                        "versions of the kernels")


def _add_sizes(p):
    """The preset overrides _resolve_preset applies."""
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--volume-size", type=int, default=None)
    p.add_argument("--quadrature", default=None, choices=["fixed", "sliced"],
                   help="override the preset's quadrature: sliced = the "
                        "slice sweep (the sweep kernels on a GPU), fixed = "
                        "the per-ray march")


def _add_common(p):
    p.add_argument("--preset", default="config1",
                   help="named BASELINE preset (config1..config5, reference)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "sweep", "reference"],
                   help='"sweep" = the slice sweep (the CUDA sweep kernels '
                        'on a GPU), "reference" = per-ray oracle, auto = '
                        "sweep when supported")
    _add_sizes(p)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the render "
                        "(Chrome trace JSON) to this directory")
    p.add_argument("--check-nan", action="store_true",
                   help="check the frame with torch.isfinite: abort naming "
                        "the non-finite output on any NaN/Inf")
    _add_device(p)


class _MaybeProfile:
    """torch.profiler around the block when a directory is given (the trace
    is written to <dir>/trace.json on exit), no-op else."""

    def __init__(self, profile_dir, device):
        self.dir, self.device = profile_dir, device
        self._prof = None

    def __enter__(self):
        if self.dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self.dir, exist_ok=True)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof.export_chrome_trace(os.path.join(self.dir,
                                                        "trace.json"))
        return False


def _get_preset(name):
    """The named preset, or exit 2 naming the presets there are."""
    from .config import get_preset
    try:
        return get_preset(name)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        raise SystemExit(2)


def _resolve_preset(args):
    p = _get_preset(args.preset)
    if args.width or args.height:
        cam = dataclasses.replace(
            p.camera,
            width=args.width or p.camera.width,
            height=args.height or p.camera.height)
        p = dataclasses.replace(p, camera=cam)
    if args.volume_size:
        p = dataclasses.replace(
            p, volume=dataclasses.replace(p.volume, size=args.volume_size))
    if args.quadrature:
        p = dataclasses.replace(p, render=dataclasses.replace(
            p.render, quadrature=args.quadrature))
    return p


def cmd_render(args):
    import torch

    from .render import render_preset
    from .utils.clock import Clock, sync
    from .utils.image import write_png
    from .utils.metrics import get_logger

    dev = torch.device(args.device)
    preset = _resolve_preset(args)
    clock = Clock()

    def do_render(t):
        with torch.no_grad():
            return render_preset(preset, t=t, backend=args.backend,
                                 device=dev)
    if args.check_nan:
        from .utils.sanitize import checked
        do_render = checked(do_render)
    with _MaybeProfile(args.profile_dir, dev):
        img = sync(do_render(args.time))
    dt = clock.stamp()
    write_png(args.out, img)
    rays = preset.camera.width * preset.camera.height
    get_logger().info("rendered %s %dx%d in %.3fs (%.2f Mrays/s) on %s -> %s",
                      preset.name, preset.camera.width, preset.camera.height,
                      dt, rays / dt / 1e6, dev, args.out)
    return 0


def animation_base_dims(cameras, grid_shape, cfg, device=None):
    """The base dims every frame of an animated camera path is planned at:
    each frame's natural dims probed (plan_base_dims, its per-pixel
    geometry on `device`, the CPU for None), the largest of each taken for
    all, as the JAX animate plans its frames. Forcing the dims changes a
    frame slightly (the base grid resamples its rays), so the port keeps it
    to return the JAX package's frames. Raises ValueError when a camera has
    no sweep axis."""
    from .ops.sweep import plan_base_dims
    dims = [plan_base_dims(c, grid_shape, cfg,
                           supersample=cfg.sweep_supersample, device=device)
            for c in cameras]
    return max(d[0] for d in dims), max(d[1] for d in dims)


def cmd_animate(args):
    import math
    import time

    import torch

    from .models.scene import build_volume
    from .ops.camera import make_camera, orbit_camera
    from .ops.integrate import reference_media_scroll
    from .ops.sweep import plan_sweep
    from .render import render_image
    from .utils.clock import Clock
    from .utils.image import AsyncFrameWriter
    from .utils.metrics import MetricsWriter, get_logger

    dev = torch.device(args.device)
    preset = _resolve_preset(args)
    os.makedirs(args.out_dir, exist_ok=True)
    medium = preset.medium
    if preset.scene:
        # A multi-volume preset (config 3): bake the scene once through the
        # helper render_scene uses, so `render` and `animate` show the same
        # content.
        from .models import scene as scene_mod
        from .render import prepare_baked_scene
        volumes = getattr(scene_mod, preset.scene)(preset.volume.size,
                                                   device=dev)
        grid, medium, _ = prepare_baked_scene(volumes, preset.render,
                                              medium)
    else:
        grid = build_volume(preset.volume, device=dev)
    n_ch = grid.shape[-1] if grid.dim() == 4 else 1
    metrics = MetricsWriter(os.path.join(args.out_dir, "metrics.jsonl"))
    log = get_logger()

    def camera_at(i):
        if args.orbit:
            return orbit_camera(2 * math.pi * i / args.frames,
                                fov_y_degrees=preset.camera.fov_y_degrees,
                                width=preset.camera.width,
                                height=preset.camera.height)
        return make_camera(preset.camera)

    cfg, light = preset.render, preset.light
    sliced = cfg.quadrature == "sliced" and args.backend in ("auto", "sweep")
    dims = None
    if sliced:
        try:
            dims = animation_base_dims(
                [camera_at(i) for i in range(args.frames)], grid.shape[:3],
                cfg, device=dev)
        except ValueError as e:
            # One wide-FOV or diagonal frame must not abort the animation:
            # match render_image's loud per-frame fallback instead.
            log.warning(
                "no sweep axis for at least one animation frame (%s); "
                "falling back to the unplanned per-frame path: expect a "
                "large slowdown", e)
            sliced = False
    if sliced:
        log.info("animation: %d frames planned at base dims %s",
                 args.frames, dims)

    collected = [] if args.video else None
    clock = Clock()
    # PNG writes run on a thread pool, so disk IO overlaps the next frame.
    with _MaybeProfile(args.profile_dir, dev), AsyncFrameWriter() as writer:
        for i in range(args.frames):
            t = i / args.fps
            scroll = (reference_media_scroll(t, n_channels=n_ch, device=dev)
                      if medium.combine == "reference" else None)
            t0 = time.perf_counter()
            plan = None
            if sliced:
                # Each frame's plan at the path's base dims, built when the
                # frame is due (one plan on the device at a time).
                plan = plan_sweep(camera_at(i), grid.shape[:3], cfg,
                                  supersample=cfg.sweep_supersample,
                                  force_base_dims=dims, device=dev)
            plan_s = time.perf_counter() - t0
            with torch.no_grad():
                # The light volume, where the preset shades, is rebuilt by
                # render_image from the grid and this frame's scroll.
                img = render_image(grid, camera_at(i), cfg, medium, light,
                                   scroll=scroll, plan=plan,
                                   backend="sweep" if sliced
                                   else args.backend)
                # uint8 on the device: a quarter of the bytes to the host,
                # the conversion utils.image.to_uint8 makes.
                frame = torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(
                    torch.uint8)
            arr = frame.cpu().numpy()
            writer.write(os.path.join(args.out_dir, f"frame_{i:05d}.png"),
                         arr)
            if collected is not None:
                collected.append(arr)
            dt = clock.stamp()
            metrics.write(frame=i, seconds=dt, plan_seconds=plan_s,
                          fps=1.0 / max(dt, 1e-9),
                          mrays_per_s=preset.camera.width
                          * preset.camera.height / dt / 1e6)
    if collected is not None:
        from .utils.video import write_video
        vpath = args.video if os.path.isabs(args.video) else os.path.join(
            args.out_dir, args.video)
        write_video(vpath, collected, fps=args.fps)
        log.info("wrote animation to %s", vpath)
    if sliced:
        metrics.write(base_dims=list(dims))
    metrics.close()
    log.info("wrote %d frames to %s", args.frames, args.out_dir)
    return 0


def cmd_info(args):
    import torch

    from .config import PRESETS

    dev = torch.device(args.device)
    if dev.type == "cuda":
        # Raises torch's own error without a GPU.
        print("device:", dev, torch.cuda.get_device_name(dev))
        print("devices:", torch.cuda.device_count())
    else:
        print("device:", dev)
    print("torch:", torch.__version__, "cuda", torch.version.cuda)
    for name, p in PRESETS.items():
        print(f"  preset {name}: volume {p.volume.size}^3, "
              f"{p.camera.width}x{p.camera.height}, "
              f"emission={p.render.emission}, "
              f"shadow_steps={p.light.shadow_steps}")
    return 0


def _fit_problem(args, dev):
    """(grid size, camera, RenderConfig, MediumConfig, LightConfig, true
    grid) of `cli fit`; the fitted grid takes the true grid's shape. With
    --preset: the preset's volume size, camera, render, medium and light
    configs under the slice sweep, and as true grid its baked scene
    (config3), its four noise channels for the reference medium
    (build_volume, as render_preset builds them), or else the FBM cloud
    with the seed of its volume's first channel. Without: the demo's 32^3
    cloud (seed 7) seen at 64x64, the emission sweep at density 8. --size,
    --image-size (a square), --width, --height and --quadrature override
    either."""
    from .config import CameraConfig, LightConfig, MediumConfig, RenderConfig
    from .models import scene as scene_mod
    from .ops.camera import make_camera

    if args.preset is None:
        size = args.size or 32
        if (args.quadrature or "sliced") == "sliced":
            # The slice sweep, differentiated through the sweep kernels
            # on a GPU; "fixed" is the per-ray march of ops/integrate.
            cfg = RenderConfig(emission=True, quadrature="sliced")
        else:
            cfg = RenderConfig(max_steps=64, step_size=4.0 / 64.0,
                               emission=True)
        med = MediumConfig(combine="single", density=8.0)
        light = LightConfig()
        side = args.image_size or 64
        cam = CameraConfig(width=side, height=side)
        seed, scene = 7, ""
    else:
        p = _get_preset(args.preset)
        size = args.size or p.volume.size
        cfg, med, light, cam = p.render, p.medium, p.light, p.camera
        cfg = dataclasses.replace(cfg, quadrature=args.quadrature
                                  or "sliced")
        if args.image_size:
            cam = dataclasses.replace(cam, width=args.image_size,
                                      height=args.image_size)
        seed, scene = p.volume.channels[0].seed, p.scene
    cam = dataclasses.replace(cam, width=args.width or cam.width,
                              height=args.height or cam.height)
    if med.combine == "reference":
        true_grid = scene_mod.build_volume(
            dataclasses.replace(p.volume, size=size), device=dev)
    elif scene:
        true_grid = scene_mod.bake_scene(
            getattr(scene_mod, scene)(size, device=dev), size, cfg)
    else:
        true_grid = scene_mod.cloud_volume(size, seed=seed, device=dev)
    return size, make_camera(cam), cfg, med, light, true_grid


def cmd_fit(args):
    import torch

    from .fit import fit_grid
    from .ops.camera import camera_rays
    from .ops.integrate import render_rays
    from .render import render_image
    from .utils.checkpoint import (adam_initial_leaves, latest_step,
                                   restore_checkpoint, save_checkpoint)
    from .utils.image import write_png
    from .utils.metrics import MetricsWriter, get_logger

    dev = torch.device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    size, cam, cfg, med, light, true_grid = _fit_problem(args, dev)
    quadrature = cfg.quadrature
    if quadrature == "sliced":
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
            ckpt_dir,
            opt_state_template=adam_initial_leaves(tuple(true_grid.shape)))
        # A checkpoint written under another quadrature would continue
        # under another loss: refuse. Checkpoints without the metadata
        # resume with a warning, as in the JAX package.
        ck_quad = extra.get("quadrature")
        if ck_quad is None:
            get_logger().warning(
                "checkpoint has no quadrature metadata; resuming under "
                "--quadrature %s", quadrature)
        elif ck_quad != quadrature:
            raise SystemExit(
                f"checkpoint at {ckpt_dir} was written with quadrature "
                f"{ck_quad!r} but --quadrature is {quadrature!r}; "
                "resuming would optimize a different loss. Re-run with "
                f"--quadrature {ck_quad} or a fresh --out-dir.")
        get_logger().info("resuming fit from step %d (%s)", start, ckpt_dir)
        init_grid = torch.as_tensor(init_grid, device=dev)
    res = fit_grid(
        target, cam, cfg, med, light, grid_size=size,
        steps=args.steps, learning_rate=args.lr, metrics=metrics,
        init_grid=init_grid, init_opt_state=init_opt, start_step=start,
        checkpoint_fn=lambda s, g, st: save_checkpoint(
            ckpt_dir, s, g, st, extra={"quadrature": quadrature}),
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


def cmd_serve(args):
    import json

    from .serve import serve
    from .utils.metrics import get_logger

    preset = _resolve_preset(args)
    result = serve(preset, port=args.port, frames=args.selftest_frames,
                   host=args.host, device=args.device)
    if result is not None:
        print(json.dumps(result, indent=1))
        if args.selftest_out:
            with open(args.selftest_out, "w") as f:
                json.dump(result, f, indent=1)
        get_logger().info("interactive self-test complete")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="volumetricrenderer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one frame to PNG")
    _add_common(pr)
    pr.add_argument("--time", type=float, default=0.0,
                    help="animation time (drives the media scroll)")
    pr.add_argument("--out", default="frame.png")
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="render an animation frame sequence")
    _add_common(pa)
    pa.add_argument("--frames", type=int, default=24)
    pa.add_argument("--fps", type=float, default=24.0)
    pa.add_argument("--orbit", action="store_true",
                    help="orbit camera path (config 4)")
    pa.add_argument("--out-dir", default="frames")
    pa.add_argument("--video", default=None,
                    help="also write the sequence as one animation file: "
                         ".apng (stdlib), .gif (Pillow), or .html "
                         "(self-contained scrubber viewer)")
    pa.set_defaults(fn=cmd_animate)

    pf = sub.add_parser("fit", help="inverse-render fit: a grid fitted to "
                                    "a render of the true grid")
    pf.add_argument("--preset", default=None,
                    help="fit at a named preset's volume size, camera, "
                         "render, medium and light (config1..config5 fit "
                         "one density channel, reference its four noise "
                         "channels); without it the demo: a 32^3 cloud "
                         "seen at 64x64")
    pf.add_argument("--size", type=int, default=None,
                    help="grid size (default 32, or the preset's)")
    pf.add_argument("--image-size", type=int, default=None,
                    help="a square target of this side (default 64, or "
                         "the preset's camera)")
    pf.add_argument("--width", type=int, default=None)
    pf.add_argument("--height", type=int, default=None)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=5e-2)
    pf.add_argument("--out-dir", default="fit_run")
    pf.add_argument("--quadrature", default=None,
                    choices=["sliced", "fixed"],
                    help="sliced = differentiate through the slice sweep "
                         "(the sweep kernels on a GPU; the default, for "
                         "every preset); fixed = the per-ray march")
    pf.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "<out-dir>/ckpt")
    _add_device(pf)
    pf.set_defaults(fn=cmd_fit)

    ps = sub.add_parser(
        "serve", help="live interactive renderer over HTTP (keys and the "
                      "mouse drive the camera, R/F the media clock)")
    ps.add_argument("--preset", default="config2")
    _add_sizes(ps)
    ps.add_argument("--port", type=int, default=8788)
    ps.add_argument("--host", default="127.0.0.1",
                    help="bind address; the server has no auth, so "
                         "non-loopback exposure (0.0.0.0) is opt-in")
    ps.add_argument("--selftest-frames", type=int, default=None,
                    help="self-drive mode: send synthetic key events, "
                         "fetch N frames through the HTTP stack, print "
                         "a JSON fps report, exit")
    ps.add_argument("--selftest-out", default=None,
                    help="write the self-drive JSON report here")
    _add_device(ps)
    ps.set_defaults(fn=cmd_serve)

    pi = sub.add_parser("info", help="device + presets")
    _add_device(pi)
    pi.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    from .utils.metrics import init_logs
    init_logs()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
