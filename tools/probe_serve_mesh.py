"""chip_smoke's serving-mesh phase alone, after D1's own checks.

Builds D1, K3, R1 and K2 (``decode_attention.cu``, ``flash_attention.cu``,
``router.cu``, ``spmm_bcsr.cu``) and prints every D1 instance's registers and spills (the
one-launch mode and the split mode's two), runs ``chip_smoke.py``'s
``phase_decode_vs_plain`` (one-launch D1 against its plain version and its
emulated order) and then ``phase_serve_mesh`` (D1's split mode against its
plain version, its order and one-device D1; the SMOKE cases, qwen3-1.7b
and llama4-scout at full width on 4 gloo ranks sharing the card).  The quickest
way to check a change to the split mode or to the serving steps on a mesh
without the whole script.

Run from the repository root on a machine with one GPU:

    python3 tools/probe_serve_mesh.py

It prints the phase's kernels rows as a JSON line and writes the phase's
summary to ``chiprun_out/serve_mesh_probe.json``.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import repro_torch  # noqa: F401  (sets the numerics flags)
    from repro_torch.kernels import build
    card = cs.phase_card()
    t0 = time.monotonic()
    info = build.build_all(["decode_attention", "flash_attention", "router",
                            "spmm_bcsr"])
    print(f"build {time.monotonic() - t0:.2f} s",
          {k: round(v["seconds"], 2) for k, v in info.items()})
    for kern, used, spills in cs.kernel_resources(
            info["decode_attention"]["log"]):
        print(f"  {kern}: {used}; {spills}")
    t0 = time.monotonic()
    cs.phase_decode_vs_plain()
    print(f"decode vs plain {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    rows, summary = cs.phase_serve_mesh(card)
    print(f"serve mesh {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "serve_mesh_probe.json"),
              "w") as f:
        json.dump(summary, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
