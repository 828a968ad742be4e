"""The segment loop's wait for prefetched features, ms a frame: the
``extract`` seconds of track_video_segments' stage counters (the wait on
the prefetch queue) over the frames it consumed, the whole window's."""

LAYER = "Decode and feature prefetch"
SOURCE = "program_counter"
UNIT = "ms"
BETTER = "lower"
MOVES = "vo_frames_per_s"


def read(layer: dict):
    vo = layer.get("vo")
    if not vo or not vo["consumed"]:
        return None
    return 1e3 * vo["stage_seconds"]["extract"] / vo["consumed"]
