"""NHWC primitives: convs (with the 3x3 kernel dispatch), pooling, BN, resize."""
