"""CLI: ``python -m apdmvs_tpu_torch <dense_folder> [--device cpu]
[--batched [--view-shards N] [--space-shards S]] [--no-volumes]`` — the
reference's ``./APD <dense_folder>`` (main.cpp:140-153). Runs on the CUDA
card unless ``--device cpu`` is given; with no card it fails. ``--batched``
runs every view of a pass as one batch (``scene.run_scene_batched``) on a
(view, space) mesh, ``--no-volumes`` the direct-warp path; with
``--coordinator host:port --num-processes P --process-id i`` (or the
``APD_COORDINATOR`` / ``APD_NUM_PROCESSES`` / ``APD_PROCESS_ID``
variables) P such commands run one batched reconstruction together over
``torch.distributed`` (``--dist-backend gloo`` for processes that share a
card). They combine as in ``apdmvs_tpu/__main__.py:84-160``, except that
``--debug-dumps`` and ``--profile-dir``, which the JAX CLI ignores under
``--batched``, are refused there, as ``--allow-missing-prior`` is."""

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
    ap.add_argument("--debug-dumps", action="store_true",
                    help="write every pass's DEBUG_NEIGHBOUR / DEBUG_COST_LINE probe files "
                    "(neighbour_map.bin, neighbour.bin, weak_cost_line.dmb) into its view's "
                    "result folder (the reference's compiled-out probes, main.h:42-43; "
                    "sequential runner only)")
    ap.add_argument("--profile-dir", default=None,
                    help="record the passes under torch.profiler and write a Chrome trace to "
                    "PROFILE_DIR/trace.json (read it with python -m apdmvs_tpu_torch.timeline; "
                    "a large run makes a large file; sequential runner only)")
    ap.add_argument("--camera-model", choices=["eth", "dtu"], default="eth",
                    help="camera-file depth-range convention (APD.cpp:84-89)")
    ap.add_argument("--volume-cache-gb", type=float, default=None,
                    help="device byte budget (GB) for the per-(problem, scale) image volumes "
                    "(default: derived from the device's memory at each scale, "
                    "scene.volume_cache_budget)")
    ap.add_argument("--num-slices", type=int, default=160,
                    help="inverse-depth slices of the plane-sweep volumes")
    ap.add_argument("--no-volumes", action="store_true",
                    help="run the direct-warp path: no plane-sweep volume is built and no "
                    "kernel of csrc/ runs (default: volumes on every device)")
    ap.add_argument("--batched", action="store_true",
                    help="run all views of each pass as one batch on the device "
                    "(scene.run_scene_batched; geometric passes read the previous pass's "
                    "depths)")
    ap.add_argument("--view-shards", type=int, default=None,
                    help="--batched: view rows of the device mesh (default: the cards of "
                    "all processes over --space-shards, at most the view count); a "
                    "device may hold several shards")
    ap.add_argument("--space-shards", type=int, default=1,
                    help="--batched: row slabs of each view's volumes, over the devices of "
                    "a view row")
    ap.add_argument("--coordinator", default=None,
                    help="--batched over several processes: the address host:port of process "
                    "0's rendezvous; run the same command in every process with "
                    "--num-processes/--process-id (or export APD_COORDINATOR / "
                    "APD_NUM_PROCESSES / APD_PROCESS_ID)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="torch.distributed backend (default nccl on cards, gloo on the CPU); "
                    "gloo lets several processes share one card")
    args = ap.parse_args(argv)
    many = (args.coordinator or args.num_processes is not None
            or args.process_id is not None)
    if not args.batched and ((args.view_shards or 1) != 1 or args.space_shards != 1 or many):
        ap.error("--view-shards, --space-shards and several processes need --batched")

    common = dict(
        seed=args.seed,
        device=args.device,
        fusion_variant=args.fusion,
        show_medium_result=args.show_medium_result,
        keep_intermediates=not args.delete_intermediates,
        max_rounds=args.max_rounds,
        min_rounds=args.min_rounds,
        camera_model=args.camera_model,
        volume_cache_gb=args.volume_cache_gb,
        num_slices=args.num_slices,
        use_volumes=not args.no_volumes,
    )
    if args.batched:
        from apdmvs_tpu_torch.parallel import multihost

        for flag, given in (("--allow-missing-prior", args.allow_missing_prior),
                            ("--debug-dumps", args.debug_dumps),
                            ("--profile-dir", args.profile_dir is not None)):
            if given:
                ap.error(f"{flag} applies to the sequential runner only")
        multihost.maybe_initialize(args.coordinator, args.num_processes, args.process_id,
                                   backend=args.dist_backend,
                                   device=scene.resolve_device(args.device))
        try:
            scene.run_scene_batched(args.dense_folder, n_view_shards=args.view_shards,
                                    n_space_shards=args.space_shards, **common)
        finally:
            multihost.shutdown()
    else:
        scene.run_scene(args.dense_folder, allow_missing_prior=args.allow_missing_prior,
                        debug_dumps=args.debug_dumps, profile_dir=args.profile_dir, **common)


if __name__ == "__main__":
    main()
