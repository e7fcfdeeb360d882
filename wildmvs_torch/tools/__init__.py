"""Counterparts of the repo's `tools/` scripts that measure what the port
computes: the fusion sensitivity study (fusion_sensitivity.py) and the
end-to-end quality drive (e2e_quality.py). ROADMAP.md lists every script
of `tools/` with its counterpart, or why it needs none."""
