"""The benchmark of ``llcomp_tpu_torch`` on one H100 (``BENCHMARK.json``).

Run from a checkout's root as ``python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.  Imports nothing of the JAX
package and nothing of JAX.
"""
