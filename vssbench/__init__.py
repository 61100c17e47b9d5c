"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``):
view reads and camera ingest of Visual Road clips on one H100.

Run one cell: ``python3 vssbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  ``harness.py`` says how the files are laid
out."""
