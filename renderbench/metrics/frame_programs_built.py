"""engine: frame functions the render graph built over the traced frames
(the change in ``engine.frame_program_count``); 0 once warm."""


def read(trace):
    return float(trace["frame_programs_built"])
