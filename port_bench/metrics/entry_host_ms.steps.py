"""Mean host milliseconds of the entry's step call (BatchedSim.step: the
tick graph's load, replay and clone issued), from the call until it
returns, before the observation's wait."""


def read(rec):
    if rec["loop"] != "closed" or rec["pixels"]:
        return None
    ms = rec["window"].entry_host_ms
    return sum(ms) / len(ms)
