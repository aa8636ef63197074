"""The benchmark of ``ml_stable_diffusion_torch`` on one NVIDIA H100: run
one cell once with ``python3 sdbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""
