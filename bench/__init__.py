"""The benchmark of the PyTorch/CUDA port (`repro_torch`) on one H100.

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json`.  Everything a cell needs is
found by name: its file `cells/<cell>.json`, the configuration
`configs/<config>.json` and its architecture's plain reference
`reference/<module>.py` (weight layout, layer, logits, loss, model
FLOPs), the traffic mix `traffic/<mix>.json` (read by the general
generator `gen.py` and driven by `drivers/<kind>.py`) and one reader
`metrics/<metric>.py` for each metric it reports.
"""
