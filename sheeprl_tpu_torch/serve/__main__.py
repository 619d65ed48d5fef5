from sheeprl_tpu_torch.serve.cli import main

if __name__ == "__main__":
    main()
