from repro_torch.kernels.ssd_scan.ops import ssd_chunk
from repro_torch.kernels.ssd_scan.ref import segsum, ssd_chunk_ref
