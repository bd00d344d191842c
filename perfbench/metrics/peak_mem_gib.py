"""peak_mem_gib: torch.cuda.max_memory_allocated() over the traced part
with the host's ranges, after a reset at its start."""


def read(ctx):
    peak = ctx["probe"].traced.get("peak_bytes")
    return None if peak is None else peak / 2**30
