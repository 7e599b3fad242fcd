"""Working memory: the allocator's peak over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
at the window's start) less the bytes of the inputs (the pool and the
operands) and of the outputs the benchmark holds for its comparison, in
GiB.  None on a run without a device."""


def read(r):
    if r.peak_bytes <= 0:
        return None
    return (r.peak_bytes - r.input_bytes - r.held_bytes) / 2**30
