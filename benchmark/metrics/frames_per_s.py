"""frames_per_s (frames/s, host clock): frames delivered to host memory
in the window, over the window's seconds."""


def read(run):
    if "frames" not in run:
        return None
    return run["frames"] / run["window_s"]
