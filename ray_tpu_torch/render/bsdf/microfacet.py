"""Microfacet helpers — the part of ``ray_tpu.render.bsdf.microfacet`` the
diffuse lobe needs.  The GGX/GTR1 distributions and VNDF samplers come with
the glossy, refractive and principled nodes (ROADMAP Queue 1 item 29)."""

from __future__ import annotations

PI = 3.14159265358979323846
