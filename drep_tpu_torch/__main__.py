from drep_tpu_torch.controller import main

main()
