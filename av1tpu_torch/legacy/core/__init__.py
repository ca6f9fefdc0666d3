"""Frame pipeline of the legacy profile: keyframe wavefront and P-frames."""
