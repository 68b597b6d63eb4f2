"""anim_frames_per_s (frames/s, host clock): shadowed animation frames
delivered to host memory in the window, over the window's seconds. Kept
apart from frames_per_s, so that each has one bound in every cell that
reports it."""


def read(run):
    if "frames" not in run:
        return None
    return run["frames"] / run["window_s"]
