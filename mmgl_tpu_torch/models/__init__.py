"""Models of the port: OPT, the CLIP vision tower, fusion."""
