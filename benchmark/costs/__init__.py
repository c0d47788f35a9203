"""Operations and bytes of the work the port does, one file per kernel."""
