"""On-demand checks: dataset range and NaN checks, the model's dimension
consistency and size, and the range of its outputs (the JAX package's
``train/diagnostic.py``).

As in the JAX package, the image check expects [-1, 1]: the training math
maps images back with ``images * 0.5 + 0.5``, so [0, 1]-normalized data is
flagged.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn


class DiagnosticTool:
    def __init__(self, save_dir: str = "debug"):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def check_data_range(self, dataset, num_samples: int = 5) -> bool:
        print("=" * 70)
        print("DATA RANGE VERIFICATION")
        print("=" * 70)
        ok = True
        for i in range(min(num_samples, len(dataset))):
            try:
                sample = dataset[i]
            except Exception as e:
                print(f"   ERROR loading sample {i}: {e}")
                ok = False
                continue
            print(f"Sample {i}: path={sample.get('path', 'N/A')}")
            for key, value in sample.items():
                if not isinstance(value, np.ndarray):
                    continue
                v = value.astype(np.float64)
                print(
                    f"   {key}: shape {value.shape} dtype {value.dtype} "
                    f"range [{v.min():.4f}, {v.max():.4f}] "
                    f"mean {v.mean():.4f} std {v.std():.4f}"
                )
                if np.isnan(v).any():
                    print("      ERROR: contains NaN!")
                    ok = False
                if np.isinf(v).any():
                    print("      ERROR: contains Inf!")
                    ok = False
                if key == "images":
                    if v.min() >= -1.01 and v.max() <= 1.01 and v.min() < -0.1:
                        print("      OK: images in [-1, 1] (upstream convention)")
                    elif v.min() >= 0:
                        print(
                            "      WARNING: images look [0, 1]-normalized; this "
                            "framework expects [-1, 1]"
                        )
                        ok = False
        print("=" * 70)
        return ok

    # ------------------------------------------------------------------
    def check_model_architecture(self, net) -> bool:
        """Print the encoder's and the field's widths and the model's size;
        False when the field's latent width is not the encoder's.  The batch
        statistics are the BatchNorm running means and variances (not their
        step counters), the leaves of the JAX ``batch_stats``."""
        print("=" * 70)
        print("MODEL ARCHITECTURE VERIFICATION")
        print("=" * 70)
        enc = net.encoder
        print(f"Encoder: {type(enc).__name__} latent_size={enc.latent_size} "
              f"multi_scale={enc.use_multi_scale}")
        print(
            f"Model: latent_size={net.latent_size} d_latent={net.d_latent} "
            f"d_in={net.d_in} d_out={net.d_out}"
        )
        ok = True
        enc_ls = enc.latent_size
        expected = sum(enc_ls) if isinstance(enc_ls, (list, tuple)) else enc_ls
        if not net.use_smart_fusion and net.latent_size != expected:
            print(
                f"   ERROR: latent size mismatch! expected {expected}, "
                f"got {net.latent_size}"
            )
            ok = False
        else:
            print("   OK: latent sizes consistent")
        n_params = sum(p.numel() for p in net.parameters())
        n_stats = sum(m.running_mean.numel() + m.running_var.numel() for m in net.modules()
                      if isinstance(m, nn.modules.batchnorm._BatchNorm)
                      and m.track_running_stats)
        print(f"Parameters: {n_params:,} (+ {n_stats:,} batch stats)")
        print("=" * 70)
        return ok

    # ------------------------------------------------------------------
    def check_model_output(self, net, sample: dict) -> bool:
        """Encode the sample's first view and query 64 seeded points on the
        net's device: rgb in [0, 1], sigma >= 0, all finite."""
        print("=" * 70)
        print("MODEL OUTPUT VERIFICATION")
        print("=" * 70)
        dev = next(net.parameters()).device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        rng = np.random.default_rng(0)
        xyz = rng.normal(size=(1, 64, 3)).astype(np.float32) * 0.3
        dirs = rng.normal(size=(1, 64, 3)).astype(np.float32)
        with torch.no_grad():
            scene = net.encode(put(sample["images"][None, :1]), put(sample["poses"][None, :1]),
                               put(sample["focal"]))
            out = net.query(scene, put(xyz), viewdirs=put(dirs), coarse=True).cpu().numpy()
        rgb, sigma = out[..., :3], out[..., 3]
        ok = True
        print(f"rgb range [{rgb.min():.4f}, {rgb.max():.4f}]")
        print(f"sigma range [{sigma.min():.4f}, {sigma.max():.4f}]")
        if not np.isfinite(out).all():
            print("   ERROR: non-finite outputs!")
            ok = False
        if rgb.min() < -1e-6 or rgb.max() > 1 + 1e-6:
            print("   ERROR: rgb outside [0, 1]!")
            ok = False
        if sigma.min() < -1e-6:
            print("   ERROR: negative sigma!")
            ok = False
        if ok:
            print("   OK: outputs well-formed")
        print("=" * 70)
        return ok
