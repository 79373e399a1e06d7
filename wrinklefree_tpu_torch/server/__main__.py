from .http import main

main()
