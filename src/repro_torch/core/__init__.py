"""The paper's network: training, the optimization ladder, quantized
nets and the synthetic digit dataset."""
