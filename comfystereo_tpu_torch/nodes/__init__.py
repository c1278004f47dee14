"""Node/API layer: ComfyUI-compatible node classes, usable standalone."""
