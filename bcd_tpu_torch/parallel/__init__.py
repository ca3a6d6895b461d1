"""Scale-out layer of the port: batches of frames over devices."""

from bcd_tpu_torch.parallel.frames import denoise_frames

__all__ = ["denoise_frames"]
