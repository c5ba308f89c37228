"""The wavefront render pipeline: ray generation → trace → surface shading
(NEE + BSDF sampling) → shadow trace → accumulate."""
