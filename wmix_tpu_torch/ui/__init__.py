"""Aux visualization layer (reference L7, ui/): BMP file IO, framebuffer
blitting with a malloc fallback, and the 12-channel rolling-waveform
oscilloscope that renders the WMT_FFT display."""
