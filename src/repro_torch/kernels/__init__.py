"""Hand-written Hopper kernels of the port, each beside its plain version.

Each kernel's wrapper counts its launches in its ``launches`` attribute, and
K4's ``selective_scan.step_launches`` those of its decode body;
``launch_counts`` reads them all, by kernel name."""
from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launches in this process, by kernel name, and
    K4's decode-body launches as ``selective_scan_step``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.local_sgd import ops as local_sgd_ops
    from repro_torch.kernels.sdca import ops as sdca_ops
    from repro_torch.kernels.ssm_scan import ops as ss_ops

    wrappers = {"local_sdca": sdca_ops.local_sdca, "flash_fwd": fa_ops.flash_fwd,
                "paged_decode": fd_ops.paged_decode, "selective_scan": ss_ops.selective_scan,
                "flash_decode": fd_ops.flash_decode,
                "paged_latent_decode": fd_ops.paged_latent_decode,
                "local_sgd": local_sgd_ops.local_sgd, "flash_bwd_dq": fa_ops.flash_bwd_dq,
                "flash_bwd_dkdv": fa_ops.flash_bwd_dkdv, "flash_bwd_dv": fa_ops.flash_bwd_dv,
                "flash_bwd_dk": fa_ops.flash_bwd_dk,
                "selective_scan_bwd": ss_ops.selective_scan_bwd,
                "selective_scan_bwd_reduce": ss_ops.selective_scan_bwd_reduce}
    counts = {name: int(w.launches) for name, w in wrappers.items()}
    counts["selective_scan_step"] = int(ss_ops.selective_scan.step_launches)
    return counts
