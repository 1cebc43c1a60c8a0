"""The benchmark of image_stitcher_tpu_torch: ``python3 stitchbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
