"""Physics models: ICs, perturb, ionization, brightness and the host-side HMF."""
