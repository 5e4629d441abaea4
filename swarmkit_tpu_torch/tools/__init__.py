"""Tools that drive and measure the port: command-line sweeps, the
scheduler's Docker-scale world and the control plane's pipeline."""
