"""kernels.device_ms_per_step: device milliseconds of the program's own
CUDA kernels (the __global__ functions of its csrc/*.cu) per traced step."""


def read(trace):
    t = trace.kernel_s()
    if t <= 0 or not trace.n_steps:
        return None
    return 1e3 * t / trace.n_steps
