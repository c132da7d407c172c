"""Conversion day, end to end: fetch the reference's tarball, preflight it,
convert it into a weight pack, and run the mel golden gate.

Each step is also a standalone CLI (see docs/CONVERSION_RUNBOOK.md):

    python -m vietvoice_tts_tpu.models.download --preflight
    python -m vietvoice_tts_tpu.models.convert models/model-bin.pt packs/v1
    python golden.py --onnx-tarball models/model-bin.pt --pack packs/v1
"""

import json
import sys

from vietvoice_tts_tpu.models.convert import convert_reference_tarball
from vietvoice_tts_tpu.models.download import ensure_model_downloaded
from vietvoice_tts_tpu.models.preflight import preflight_report

# 1. Fetch (cached, resumable; ~GB from HuggingFace).
tarball = ensure_model_downloaded(dest="models/model-bin.pt")

# 2. Preflight: fails in seconds with a checklist instead of mid-conversion.
report = preflight_report(tarball)
print(json.dumps({"ok": report["ok"], "blockers": report["blockers"]}, indent=2))
if not report["ok"]:
    sys.exit("preflight blocked — fix the listed blockers first")

# 3. Convert into a weight pack (auto-discovers the starter name map).
conv = convert_reference_tarball(tarball, "packs/v1")
if conv["weights"].get("unresolved"):
    sys.exit(f"unresolved leaves: {conv['weights']['unresolved'][:5]}")

# 4. Numerics gate: mel allclose (atol 1e-2) vs the ONNX graphs.
#    (Run as a subprocess/CLI in real life — it prints one JSON line.)
print("now run: python golden.py --onnx-tarball", tarball, "--pack packs/v1")
