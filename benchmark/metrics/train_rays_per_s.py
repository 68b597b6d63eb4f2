"""train_rays_per_s (rays/s, host clock): pixels of the target times the
fit steps completed in the window, over the window's seconds (the whole
fit_grid call: its plan, its resume, every step and its syncs)."""


def read(run):
    if "steps" not in run:
        return None
    return run["steps"] * run["rays_per_step"] / run["window_s"]
