"""The benchmark of genie2_tpu_torch on NVIDIA GPUs: `python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout. See BENCHMARK.json and PERF.md."""
