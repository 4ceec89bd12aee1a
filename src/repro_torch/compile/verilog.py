"""Verilog backend — synthesizable structural RTL + EGFET report.

The port of `repro.compile.verilog`; its text is the reference's, byte
for byte, the banner naming the reference's module included, so a design
emitted by either package reads the same.

Emits the subset of structural Verilog-2001 a printed-electronics PDK flow
(Synopsys DC on the EGFET library, cf. the paper's Sec. 5 setup) consumes:
scalar ports, `wire` declarations, one primitive-gate `assign` per line and
named-port module instantiations — nothing behavioural.  Structure mirrors
the paper's bespoke architecture: one module per distinct PCC / popcount
circuit (deduplicated by lowered-netlist content), one `argmax` module, and
a top-level classifier module wiring features -> hidden PCCs -> XNOR NOT
gates -> per-class score popcounts -> argmax.

Statements are emitted in topological (levelized) order, which lets the
single-pass reader in `repro_torch.compile.vread` re-evaluate the file and pin
bit-identity against the compiled `CircuitProgram`.

The EGFET area/power report comes from the *same* `CircuitIR` the device
backend executes — gate histogram, logic depth, core + sensor-interface
area/power and the Sec.-5 printed power-source verdict.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

from repro_torch.compile.ir import (CircuitIR, CompiledClassifier,
                                    argmax_netlist, hidden_input_map,
                                    lower_netlist)
from repro_torch.core.circuits import Netlist
from repro_torch.hw.egfet import Gate, HwCost, interface_cost, power_source

# one primitive gate per assign; {a}/{b} are operand signal names
_OP_EXPR = {
    int(Gate.CONST0): "1'b0",
    int(Gate.CONST1): "1'b1",
    int(Gate.INPUT): "{a}",
    int(Gate.BUF): "{a}",
    int(Gate.NOT): "~{a}",
    int(Gate.AND): "({a} & {b})",
    int(Gate.OR): "({a} | {b})",
    int(Gate.XOR): "({a} ^ {b})",
    int(Gate.NAND): "~({a} & {b})",
    int(Gate.NOR): "~({a} | {b})",
    int(Gate.XNOR): "~({a} ^ {b})",
    int(Gate.ANDN): "({a} & ~{b})",
    int(Gate.ORN): "({a} | ~{b})",
}


def _sanitize(name: str) -> str:
    s = re.sub(r"[^A-Za-z0-9_]", "_", name)
    s = re.sub(r"__+", "_", s).strip("_")
    if not s or not (s[0].isalpha() or s[0] == "_"):
        s = "m_" + s
    return s


def emit_netlist_module(nl_or_ir: Netlist | CircuitIR, name: str) -> str:
    """One circuit -> one Verilog module (inputs x0.., outputs y0..).

    `Netlist` arguments are lowered first, so the RTL carries only live
    gates in level order.
    """
    ir = nl_or_ir if isinstance(nl_or_ir, CircuitIR) else lower_netlist(nl_or_ir)

    def sig(node: int) -> str:
        return f"x{node}" if node < ir.n_inputs else f"n{node}"

    ports = [f"    input  x{i}" for i in range(ir.n_inputs)]
    ports += [f"    output y{k}" for k in range(ir.n_outputs)]
    lines = [f"module {name} ("] + [p + "," for p in ports[:-1]] + [ports[-1], ");"]
    for g in range(ir.n_gates):
        lines.append(f"  wire n{ir.n_inputs + g};")
    for g in range(ir.n_gates):
        expr = _OP_EXPR[int(ir.op[g])].format(a=sig(int(ir.in0[g])),
                                              b=sig(int(ir.in1[g])))
        lines.append(f"  assign n{ir.n_inputs + g} = {expr};")
    for k, node in enumerate(ir.outputs):
        lines.append(f"  assign y{k} = {sig(int(node))};")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


class _ModuleLibrary:
    """Content-addressed module dedup: identical lowered netlists share RTL."""

    def __init__(self):
        self._by_key: dict[tuple, str] = {}
        self.texts: list[str] = []

    def add(self, nl: Netlist) -> tuple[str, CircuitIR]:
        ir = lower_netlist(nl)
        key = (ir.n_inputs, ir.op.tobytes(), ir.in0.tobytes(),
               ir.in1.tobytes(), ir.outputs.tobytes())
        if key not in self._by_key:
            mod = f"m{len(self._by_key)}_{_sanitize(nl.name or 'circuit')}"
            self._by_key[key] = mod
            self.texts.append(emit_netlist_module(ir, mod))
        return self._by_key[key], ir


def emit_classifier_verilog(cc: CompiledClassifier,
                            top: str = "tnn_classifier") -> str:
    """Full classifier RTL: PCC/PC/argmax modules + top-level wiring.

    Top-level ports: `x0..x{F-1}` (ABC comparator outputs) in, class-index
    bits `k0..k{IB-1}` (LSB-first) out.  Statement order in every module
    body is topological, a guarantee `vread.VerilogDesign` relies on.
    """
    lib = _ModuleLibrary()
    body: list[str] = []

    # hidden plane
    h_sigs = []
    for i, nl in enumerate(cc.hidden_nls):
        mod, ir = lib.add(nl)
        fmap = hidden_input_map(cc.w1t[:, i], nl.n_inputs)
        h = f"h{i}"
        body.append(f"  wire {h};")
        conns = [f".x{p}(x{fid})" for p, fid in enumerate(fmap)]
        conns.append(f".y0({h})")
        body.append(f"  {mod} u_h{i} ({', '.join(conns)});")
        h_sigs.append(h)

    # output plane: XNOR NOTs + per-class score popcounts, zero-extended
    j = cc.score_bits
    score_sigs: list[list[str]] = []
    for o in range(cc.n_classes):
        col = cc.w2t[:, o]
        in_sigs = [h_sigs[i] for i in np.where(col == 1)[0]]
        for i in np.where(col == -1)[0]:
            neg = f"hn{o}_{i}"
            body.append(f"  wire {neg};")
            body.append(f"  assign {neg} = ~{h_sigs[i]};")
            in_sigs.append(neg)
        sigs = [f"s{o}_{k}" for k in range(j)]
        for s in sigs:
            body.append(f"  wire {s};")
        if not in_sigs:
            for s in sigs:
                body.append(f"  assign {s} = 1'b0;")
        else:
            nl = cc.out_nls[o]
            mod, ir = lib.add(nl)
            conns = [f".x{p}({s})" for p, s in enumerate(in_sigs)]
            conns += [f".y{k}({sigs[k]})" for k in range(ir.n_outputs)]
            body.append(f"  {mod} u_o{o} ({', '.join(conns)});")
            for k in range(ir.n_outputs, j):
                body.append(f"  assign {sigs[k]} = 1'b0;")
        score_sigs.append(sigs)

    # argmax plane
    am_mod, am_ir = lib.add(argmax_netlist(cc.n_classes, j))
    idx_bits = am_ir.n_outputs
    conns = [f".x{o * j + k}({score_sigs[o][k]})"
             for o in range(cc.n_classes) for k in range(j)]
    conns += [f".y{b}(k{b})" for b in range(idx_bits)]
    body.append(f"  {am_mod} u_argmax ({', '.join(conns)});")

    ports = [f"    input  x{i}" for i in range(cc.n_features)]
    ports += [f"    output k{b}" for b in range(idx_bits)]
    header = ([f"// {cc.name}: printed-TNN classifier "
               f"({cc.n_features} features, {cc.n_classes} classes, "
               f"{cc.ir.n_gates} gates, depth {cc.ir.depth})",
               f"module {top} ("]
              + [p + "," for p in ports[:-1]] + [ports[-1], ");"])
    text = "\n".join(["// Generated by repro.compile.verilog — structural "
                      "EGFET netlist, one assign per gate.", ""]
                     + lib.texts
                     + header + body + ["endmodule", ""])
    return text


def egfet_report(cc: CompiledClassifier, interface: str | None = "abc") -> dict:
    """EGFET area/power report from the compiled IR (+ sensor interface)."""
    core = cc.ir.cost()
    iface = (interface_cost(cc.n_features, interface) if interface
             else HwCost(0.0, 0.0))
    total = core + iface
    return {
        "name": cc.name,
        "n_features": cc.n_features,
        "n_classes": cc.n_classes,
        "n_gates": cc.ir.n_gates,
        "logic_depth": cc.ir.depth,
        "gates": cc.ir.gate_histogram(),
        "core_area_mm2": round(core.area_mm2, 4),
        "core_power_mw": round(core.power_mw, 5),
        "interface": interface,
        "interface_area_mm2": round(iface.area_mm2, 4),
        "interface_power_mw": round(iface.power_mw, 5),
        "total_area_mm2": round(total.area_mm2, 4),
        "total_area_cm2": round(total.area_cm2, 5),
        "total_power_mw": round(total.power_mw, 5),
        "power_source": power_source(total.power_mw),
    }


def write_artifacts(cc: CompiledClassifier, out_dir: str | Path,
                    base: str | None = None,
                    interface: str | None = "abc",
                    dataset: str | None = None,
                    replicas: int = 1,
                    provenance: dict | None = None,
                    register: bool = True) -> dict[str, str]:
    """Write `<base>.v` + `<base>_egfet.json` + a servable program bundle
    under `out_dir`, and register the design as tenant `base` in the
    directory's `fleet.json` manifest (a serving fleet consumes it).
    `replicas` is a serving hint: how many engine replicas the fleet
    should stand up for this tenant by default.  `provenance` (seed,
    generations, objective values, config fingerprint — whatever produced
    this design) is stamped into the manifest row so a later promotion
    decision can tell *which search* a live tenant came from.

    `register=False` writes the files but skips the manifest: manifest
    registration is read-modify-write on one `fleet.json`, so concurrent
    writers (the zoo batch compiler's worker pool) emit with
    `register=False` and the parent registers the returned `entry` rows
    serially via `artifact.register_tenant`."""
    from repro_torch.compile import artifact as A

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    base = base or _sanitize(cc.name or "tnn_classifier")
    vpath = out / f"{base}.v"
    rpath = out / f"{base}_egfet.json"
    ppath = out / f"{base}{A.PROGRAM_SUFFIX}"
    vpath.write_text(emit_classifier_verilog(cc))
    rpath.write_text(json.dumps(egfet_report(cc, interface), indent=2) + "\n")
    A.save_program(cc, ppath)
    entry = {
        "name": base,
        "program": str(ppath),
        "verilog": str(vpath),
        "report": str(rpath),
        # only an explicit dataset is trustworthy here: ir.meta["dataset"]
        # holds the model *name*, which need not be a loadable dataset
        "dataset": dataset,
        "n_features": cc.n_features,
        "n_classes": cc.n_classes,
        "n_gates": cc.ir.n_gates,
        "replicas": int(replicas),
        # the digest save_program just wrote — no need to re-hash the npz
        "sha256": ppath.with_name(ppath.name
                                  + A.SHA_SUFFIX).read_text().strip(),
    }
    if provenance is not None:
        entry["provenance"] = dict(provenance)
    paths = {"verilog": str(vpath), "report": str(rpath),
             "program": str(ppath), "entry": entry}
    if register:
        paths["manifest"] = str(A.register_tenant(out, entry))
    return paths
