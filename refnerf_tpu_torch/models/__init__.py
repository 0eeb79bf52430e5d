"""The Ref-NeRF model, its volume rendering and the chunked renderer."""
