"""Host ms a frame in the tracker's calls (each ends in a device-to-host
copy): the ``track`` seconds of track_video_segments' stage counters over
the frames it consumed, in the traced run (the profiler's overhead in)."""

LAYER = "Tracking step"
SOURCE = "program_counter"
UNIT = "ms"
BETTER = "lower"
MOVES = "vo_frames_per_s"


def read(layer: dict):
    vo = layer.get("vo")
    if not vo or not vo["consumed"]:
        return None
    return 1e3 * vo["stage_seconds"]["track"] / vo["consumed"]
