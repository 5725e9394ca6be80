"""setup_s: from the start of the process to the first encode call of the
window (import, CUDA, the kernel library, the clip, the encoder, the W
warm-up frames)."""


def read(run):
    return run["setup_s"]
