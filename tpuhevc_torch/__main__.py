from .app import main

raise SystemExit(main())
