"""Window helpers, the fused Swin-block kernel, attention and upconv."""
