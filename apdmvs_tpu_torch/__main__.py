"""CLI: ``python -m apdmvs_tpu_torch <dense_folder> [--device cpu]`` — the
reference's ``./APD <dense_folder>`` (main.cpp:140-153). Runs on the CUDA
card unless ``--device cpu`` is given; with no card it fails."""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from apdmvs_tpu_torch import scene

    ap = argparse.ArgumentParser(
        prog="apdmvs_tpu_torch",
        description="APD-MVS multi-view stereo reconstruction (PyTorch / CUDA)",
    )
    ap.add_argument("dense_folder", help="dataset folder with images/ cams/ pair.txt")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs the plain "
                    "PyTorch versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0, help="random seed")
    ap.add_argument("--fusion", choices=scene.FUSION_VARIANTS, default="eth",
                    help="fusion variant (APD.cpp:826-1296); eth-device runs the ETH "
                    "algorithm on --device (fusion_device.py)")
    ap.add_argument("--show-medium-result", action="store_true",
                    help="dump per-pass depth/normal/weak JPEGs (main.cpp:127-134)")
    ap.add_argument("--delete-intermediates", action="store_true",
                    help="remove per-view result dirs after fusion (main.cpp:220-230)")
    ap.add_argument("--max-rounds", type=int, default=None, help="cap pyramid rounds")
    ap.add_argument("--min-rounds", type=int, default=None,
                    help="force at least this many pyramid rounds (rounds after the first "
                    "run the APD weak machinery) even below the 1000 px trigger")
    ap.add_argument("--allow-missing-prior", action="store_true",
                    help="re-initialise a view whose prior state files are missing "
                    "instead of failing (the reference exits, APD.cpp:514-518)")
    ap.add_argument("--camera-model", choices=["eth", "dtu"], default="eth",
                    help="camera-file depth-range convention (APD.cpp:84-89)")
    ap.add_argument("--volume-cache-gb", type=float, default=6.0,
                    help="device byte budget for the per-(problem, scale) image volumes")
    ap.add_argument("--num-slices", type=int, default=160,
                    help="inverse-depth slices of the plane-sweep volumes")
    args = ap.parse_args(argv)

    scene.run_scene(
        args.dense_folder,
        seed=args.seed,
        device=args.device,
        fusion_variant=args.fusion,
        show_medium_result=args.show_medium_result,
        keep_intermediates=not args.delete_intermediates,
        max_rounds=args.max_rounds,
        min_rounds=args.min_rounds,
        camera_model=args.camera_model,
        allow_missing_prior=args.allow_missing_prior,
        volume_cache_gb=args.volume_cache_gb,
        num_slices=args.num_slices,
    )


if __name__ == "__main__":
    main()
