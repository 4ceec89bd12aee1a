"""repro_torch.compile — lower -> emit -> read back -> serve.

Lowers trained and evolved classifiers (`core.tnn` + NSGA-II netlist
selections) into a single levelized gate IR with two backends: a
bit-packed program on the device for batched sensor-stream inference, and
synthesizable structural Verilog with an EGFET area/power report (plus an
independent reader that re-evaluates the emitted RTL in numpy).
`python -m repro_torch.compile.export` runs the whole path.
"""
from repro_torch.compile.artifact import (
    ArtifactCorruptError,
    load_manifest,
    load_manifest_doc,
    load_program,
    register_tenant,
    save_program,
    verify_program_bundle,
)
from repro_torch.compile.ir import (
    CircuitIR,
    CompiledClassifier,
    argmax_netlist,
    lower,
    lower_classifier,
    lower_netlist,
)
from repro_torch.compile.program import CircuitProgram
from repro_torch.compile.verilog import (
    egfet_report,
    emit_classifier_verilog,
    emit_netlist_module,
    write_artifacts,
)
from repro_torch.compile.vread import VerilogDesign, eval_classifier_verilog

__all__ = [
    "ArtifactCorruptError",
    "CircuitIR",
    "CompiledClassifier",
    "CircuitProgram",
    "VerilogDesign",
    "argmax_netlist",
    "egfet_report",
    "emit_classifier_verilog",
    "emit_netlist_module",
    "eval_classifier_verilog",
    "load_manifest",
    "load_manifest_doc",
    "load_program",
    "verify_program_bundle",
    "lower",
    "lower_classifier",
    "lower_netlist",
    "register_tenant",
    "save_program",
    "write_artifacts",
]
