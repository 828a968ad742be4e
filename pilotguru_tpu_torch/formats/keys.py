"""JSON key names of the pilotguru data formats (copied from
pilotguru_tpu/formats/keys.py, which mirrors the reference's
include/io/json_converters.hpp), so the port reads and writes files
interchangeable with the JAX package's, the reference binaries' and the
Android recorder app's."""

ACCELERATIONS = "accelerations"
ANGULAR_VELOCITY = "angular_velocity"
CAN_FRAMES = "can_frames"
CAN_FRAME = "can_frame"
FORWARD_AXIS = "forward_axis"
FRAMES = "frames"
LOCATIONS = "locations"
PLANE = "plane"
TRAJECTORY = "trajectory"
TIME_USEC = "time_usec"
IS_LOST = "is_lost"
FRAME_ID = "frame_id"
POSE = "pose"
PLANAR_DIRECTION = "planar_direction"
ROTATIONS = "rotations"
SPEED_M_S = "speed_m_s"
STEERING = "steering"
STEERING_ANGLE_DEGREES = "steering_angle_degrees"
VELOCITIES = "velocities"

TRANSLATION = "translation"
W = "w"
X = "x"
Y = "y"
Z = "z"
ROTATION = "rotation"
