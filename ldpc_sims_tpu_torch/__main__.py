from ldpc_sims_tpu_torch.cli.main import main

main()
