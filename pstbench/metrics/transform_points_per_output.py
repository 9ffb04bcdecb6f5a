"""Points of the inversion's transforms over the output samples they kept,
across the traced stretch: the growth of the program's
``inversion_transform_points`` counter over that of its
``inversion_output_samples`` (Run.counters). It is what the frame length
costs: N / (N - 2 * output overlap) of each transform. None where the
program has no such counters or kept nothing in the stretch."""


def read(run):
    c = run.counters
    if c is None or "inversion_transform_points" not in c or "inversion_output_samples" not in c:
        return None
    if c["inversion_output_samples"] <= 0:
        return None
    return c["inversion_transform_points"] / c["inversion_output_samples"]
