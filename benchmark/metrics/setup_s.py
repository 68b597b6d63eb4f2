"""setup_s (s, host clock): from the process's start to the first timed
call of the window: imports, the CUDA context, the kernels' libraries
(built by nvcc in a checkout's first run), the inputs, the program's
set-up and warm-up."""


def read(run):
    return run["setup_s"]
