"""lm_solve_host_ms_per_frame: host time inside the benchmark's range
around ``pipeline.slam.lm_solve`` (the linearizations, the reduced
solves, the trial costs, accept/reject), per traced frame."""


def read(run):
    t = run.trace_summary
    if t is None or "lm_solve" not in t.spans:
        return None
    return t.spans["lm_solve"] * 1e-3 / t.frames
