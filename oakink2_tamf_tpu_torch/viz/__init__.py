"""Headless visualization of hand/object sequences (port of
oakink2_tamf_tpu/viz): matplotlib strips and GIFs, camera-frame overlays,
the self-contained HTML viewer. numpy arrays or CPU tensors in."""
