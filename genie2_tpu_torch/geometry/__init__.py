from genie2_tpu_torch.geometry.rigid import Rigid, rot_matmul, rot_vec_mul
from genie2_tpu_torch.geometry.quat import quat_to_rot, rot_to_quat
from genie2_tpu_torch.geometry.frames import distogram, frenet_frames
from genie2_tpu_torch.geometry.encoding import sinusoidal_encoding

__all__ = [
    "Rigid",
    "rot_matmul",
    "rot_vec_mul",
    "quat_to_rot",
    "rot_to_quat",
    "frenet_frames",
    "distogram",
    "sinusoidal_encoding",
]
