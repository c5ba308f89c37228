"""BSDF lobes (evaluate/sample pairs) and microfacet helpers."""
