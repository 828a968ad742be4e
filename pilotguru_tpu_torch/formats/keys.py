"""JSON key names of the trajectory and fit_motion formats (copied from
pilotguru_tpu/formats/keys.py, which mirrors the reference's
include/io/json_converters.hpp), so the port writes files interchangeable
with the JAX package's and the reference binaries'."""

ACCELERATIONS = "accelerations"
ANGULAR_VELOCITY = "angular_velocity"
FORWARD_AXIS = "forward_axis"
LOCATIONS = "locations"
ROTATIONS = "rotations"
SPEED_M_S = "speed_m_s"
STEERING = "steering"
VELOCITIES = "velocities"
PLANE = "plane"
TRAJECTORY = "trajectory"
TIME_USEC = "time_usec"
IS_LOST = "is_lost"
FRAME_ID = "frame_id"
POSE = "pose"
PLANAR_DIRECTION = "planar_direction"

TRANSLATION = "translation"
W = "w"
X = "x"
Y = "y"
Z = "z"
ROTATION = "rotation"
