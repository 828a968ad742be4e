"""Frames a tracking chunk dispatched and then handed back to the next,
as a share of the frames chunks dispatched: refed / (chunk_frames +
refed) of track_video_segments' stage counters."""

LAYER = "Segment loop and chunking"
SOURCE = "program_counter"
UNIT = "%"
BETTER = "lower"
MOVES = "vo_frames_per_s"


def read(layer: dict):
    vo = layer.get("vo")
    if not vo:
        return None
    stages = vo["stage_seconds"]
    dispatched = stages["chunk_frames"] + stages["refed"]
    if not dispatched:
        return None
    return 100.0 * stages["refed"] / dispatched
