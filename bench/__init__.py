"""The benchmark of the PyTorch / CUDA port (`repro_torch`).

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json on the card(s) of this machine
and prints one JSON result line. Everything one configuration, one
traffic mix or one per-layer metric needs lives in files of its own,
found by the names in BENCHMARK.json: configs/<config>.json,
traffic/<mix>.json, metrics/<metric>.py, cost/<kind>.py,
reference/<kind>.py and port/<kind>.py.
"""
