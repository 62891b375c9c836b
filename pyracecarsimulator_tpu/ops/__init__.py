from .common import beam_angles, quantize_angles, rays_from_poses
from .raymarch_xla import march_rays, scan_poses
from .raycast_segments import raycast_all, raycast_tiled, scan_poses_segments
from .raycast_grad import raycast_all_diff, raycast_tiled_diff
from .raycast_general import (raycast_general, raycast_general_tiled,
                              scan_poses_general)
from .soft_edt import soft_edt, scan_from_occupancy
from .noise import add_scan_noise
